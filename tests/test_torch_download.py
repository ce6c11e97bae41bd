"""The port's dataset formatting (`data.download`) held against the JAX
package's, and the partitions of the caches it writes.

Both packages format the same trees, made from a numpy seed under the
test's directory: the LibriTTS, VCTK and DAPS trees of
`tests/test_download.py` and a generic <speaker>/<utterance>.wav tree, at
16, 24, 44.1 and 48 kHz. Every file either package writes (wavs at both
rates, transcripts, speakers.json, correspondence.json) must be equal to
the byte. From the port's LibriTTS cache both packages must compute the
same partition; from its VCTK cache the same test split, the port's train
and valid splits being the JAX package's less the other microphones'
takes of test utterances, which the JAX package's reading of
correspondence.json fails to exclude. The JAX package reads and writes through
its module's DATA_DIR, CACHE_DIR and ASSETS_DIR, which each test points
at its own directory; the JAX package's shipped partitions must be left
as they were.
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import promonet_tpu

import promonet_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
RATES = (16000, 24000, 44100, 48000)
SHIPPED_PARTITIONS = ROOT / 'promonet_tpu' / 'assets' / 'partitions'


def _digest(directory):
    """SHA-256 over the relative paths and bytes of a directory's files"""
    digest = hashlib.sha256()
    for file in sorted(path for path in directory.rglob('*')
                       if path.is_file()):
        digest.update(str(file.relative_to(directory)).encode() + b'\0')
        digest.update(file.read_bytes())
    return digest.hexdigest()


def _files(directory):
    """{relative path: bytes} of every file under a directory"""
    return {
        str(file.relative_to(directory)): file.read_bytes()
        for file in directory.rglob('*') if file.is_file()}


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """(the port's configuration, the JAX package's cache) over one
    DATA_DIR; the JAX package's shipped partitions checked unchanged"""
    shipped = _digest(SHIPPED_PARTITIONS)
    monkeypatch.setattr(promonet_tpu, 'DATA_DIR', tmp_path / 'data')
    monkeypatch.setattr(promonet_tpu, 'CACHE_DIR', tmp_path / 'jax')
    monkeypatch.setattr(promonet_tpu, 'ASSETS_DIR', tmp_path / 'jax_assets')
    config = port.config.load().replace(
        DATA_DIR=tmp_path / 'data', CACHE_DIR=tmp_path / 'port',
        ASSETS_DIR=tmp_path / 'port_assets',
        PARTITIONS_DIR=tmp_path / 'port_partitions',
        RUNS_DIR=tmp_path / 'port_runs')
    yield config, tmp_path / 'jax'
    assert _digest(SHIPPED_PARTITIONS) == shipped


def _write_wav(path, rng, seconds=0.3, sample_rate=16000, amplitude=0.5):
    """A seeded harmonic tone with a noise floor, peaking at `amplitude`"""
    path.parent.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    pitch = rng.uniform(100., 300.)
    audio = sum(0.5 ** k * np.sin(2 * np.pi * k * pitch * t + rng.uniform(
        0, 2 * np.pi)) for k in range(1, 4))
    audio += 0.05 * rng.standard_normal(len(t))
    audio = amplitude * audio / np.abs(audio).max()
    port.utils.audio.save(path, audio.astype(np.float32)[None], sample_rate)


def _trees(data, sample_rate, seed=0):
    """The JAX test's LibriTTS, VCTK and DAPS trees, with a speaker ID
    that sorts before another of fewer digits ('1355' before '196'), and a
    generic tree, all at `sample_rate`"""
    rng = np.random.default_rng(seed)
    libritts = data / 'libritts' / 'train-clean-100'
    for name, text in (
        ('40_111_000001_000000', 'hello there'),
        ('40_111_000002_000000', 'general kenobi'),
        ('669_222_000001_000000', 'another speaker'),
        ('196_333_000001_000000', 'fewer digits'),
        ('1355_444_000001_000000', 'sorts first'),
    ):
        speaker, chapter = name.split('_')[:2]
        folder = libritts / speaker / chapter
        _write_wav(folder / f'{name}.wav', rng, sample_rate=sample_rate)
        (folder / f'{name}.normalized.txt').write_text(text)

    vctk = data / 'vctk'
    for stem in ('p225_001_mic1', 'p225_001_mic2', 'p225_002_mic1',
                 'p226_001_mic1'):
        _write_wav(vctk / 'wav48_silence_trimmed' / stem[:4] / f'{stem}.wav',
                   rng, sample_rate=sample_rate)
    for stem in ('p225_001', 'p226_001'):
        (vctk / 'txt' / stem[:4]).mkdir(parents=True, exist_ok=True)
        (vctk / 'txt' / stem[:4] / f'{stem}.txt').write_text(f'said {stem}')

    daps = data / 'daps' / 'clean'
    for name, amplitude in (('f1_script1_clean', 0.1),
                            ('f10_script1_clean', 0.9),
                            ('m3_script1_clean', 0.5)):
        _write_wav(daps / f'{name}.wav', rng, sample_rate=sample_rate,
                   amplitude=amplitude)
        (daps / f'{name}.txt').write_text(name.replace('_', ' '))

    generic = data / 'generic'
    for speaker, utterance, amplitude in (
            ('bob', 'a', 0.2), ('bob', 'b', 0.6), ('alice', 'x', 0.5)):
        _write_wav(generic / speaker / f'{utterance}.wav', rng,
                   sample_rate=sample_rate, amplitude=amplitude)
    (generic / 'bob' / 'a.txt').write_text('generic words')


@pytest.mark.parametrize('sample_rate', RATES)
def test_formatted_caches_equal_jax_byte_for_byte(dirs, sample_rate):
    """Every file of every dataset's cache is the JAX package's"""
    config, jax_cache = dirs
    _trees(config.DATA_DIR, sample_rate)
    names = ['libritts', 'vctk', 'daps', 'generic']
    port.data.download.datasets(names, config)
    promonet_tpu.data.download.datasets(names)

    ours, theirs = _files(config.CACHE_DIR), _files(jax_cache)
    assert sorted(ours) == sorted(theirs)
    assert [name for name in ours if ours[name] != theirs[name]] == []
    # Both rates, transcripts and the two maps were written
    assert 'libritts/speakers.json' in ours
    assert 'vctk/correspondence.json' in ours
    assert sum(name.endswith('-100.wav') for name in ours) == 5 + 3 + 3 + 3
    speakers = json.loads(ours['libritts/speakers.json'])
    assert list(speakers) == sorted(speakers)
    assert speakers['1355'][0] < speakers['196'][0]
    _, rate = port.utils.audio.load(
        config.CACHE_DIR / 'vctk' / '0000' / '000000-100.wav')
    assert rate == config.SAMPLE_RATE


def test_normalize_gain_matches_jax():
    """Silence and loud audio unchanged, quiet audio gained to 0.35, all
    float32, as in the JAX package"""
    rng = np.random.default_rng(1)
    for peak in (0., 0.05, 0.3499, 0.35, 0.8):
        audio = rng.uniform(-1, 1, (1, 1000)).astype(np.float32)
        audio *= peak / max(np.abs(audio).max(), 1e-12)
        ours = port.data.download.normalize_gain(audio)
        theirs = promonet_tpu.data.download.normalize_gain(audio)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
        expected = 0.35 if 0 < peak < 0.35 else peak
        assert np.abs(ours).max() == pytest.approx(expected, rel=1e-6)
    assert port.data.download.PEAK_TARGET == \
        promonet_tpu.data.download.PEAK_TARGET


def test_flac_and_missing_datasets_raise_as_in_jax(dirs):
    """A FLAC take raises RuntimeError, a dataset not under DATA_DIR
    FileNotFoundError, in both packages"""
    config, _ = dirs
    take = config.DATA_DIR / 'vctk' / 'wav48_silence_trimmed' / 'p225' / \
        'p225_001_mic1.flac'
    take.parent.mkdir(parents=True)
    take.write_bytes(b'fLaC')
    (config.DATA_DIR / 'vctk' / 'txt' / 'p225').mkdir(parents=True)
    (config.DATA_DIR / 'vctk' / 'txt' / 'p225' / 'p225_001.txt').write_text(
        'flac')
    for datasets, kwargs in ((port.data.download.datasets, {'config': config}),
                             (promonet_tpu.data.download.datasets, {})):
        with pytest.raises(RuntimeError, match='FLAC'):
            datasets(['vctk'], **kwargs)
        with pytest.raises(FileNotFoundError, match='libritts'):
            datasets(['libritts'], **kwargs)


def test_cli_formats_without_jax(dirs, tmp_path):
    """`python -m promonet_tpu_torch.data.download` in a process where
    importing JAX or the JAX package fails writes the JAX package's
    cache, and its notifications under the configuration's RUNS_DIR"""
    config, jax_cache = dirs
    _trees(config.DATA_DIR, 24000, seed=2)
    config_file = tmp_path / 'download.py'
    config_file.write_text('\n'.join(
        ["MODULE = 'promonet_tpu_torch'"] +
        [f'{name} = {str(getattr(config, name))!r}'
         for name in ('DATA_DIR', 'CACHE_DIR', 'RUNS_DIR')]))
    # An import hook refuses them: a None in sys.modules, which also
    # blocks an import, trips scipy's check for JAX arrays
    blocked = ('jax', 'jaxlib', 'flax', 'orbax', 'promonet_tpu')
    code = '\n'.join([
        'import importlib.abc, runpy, sys',
        'class Refuse(importlib.abc.MetaPathFinder):',
        '    def find_spec(self, name, path=None, target=None):',
        f'        if name.split(".")[0] in {blocked!r}:',
        '            raise ImportError(name)',
        'sys.meta_path.insert(0, Refuse())',
        "runpy.run_module('promonet_tpu_torch.data.download',",
        "                 run_name='__main__', alter_sys=True)",
        f'sys.exit(any(name.split(".")[0] in {blocked!r}',
        '              for name in sys.modules))'])
    result = subprocess.run(
        [sys.executable, '-c', code, '--datasets', 'libritts', 'vctk',
         '--config', str(config_file), '--gpu', '-1'],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert result.returncode == 0, result.stdout + result.stderr

    promonet_tpu.data.download.datasets(['libritts', 'vctk'])
    ours, theirs = _files(config.CACHE_DIR), _files(jax_cache)
    assert len(ours) == 5 * 3 + 1 + 3 * 3 + 1
    assert ours == theirs
    notes = (config.RUNS_DIR / 'notifications.jsonl').read_text().splitlines()
    assert [json.loads(line)['status'] for line in notes] == [
        'started', 'completed']


###############################################################################
# Partitions of the formatted caches
###############################################################################


# LibriTTS speakers besides the held-out ones
OTHER_LIBRITTS = ('19', '211', '1034', '2007')


def _libritts_tree(data, rng):
    """The ten held-out speakers with two 4.2 s utterances and one short
    one each, four other speakers with one long and two short ones"""
    held_out = port.partition.core.ADAPTATION_SPEAKERS['libritts']
    root = data / 'libritts' / 'train-clean-100'
    for speaker in (*held_out, *OTHER_LIBRITTS):
        lengths = (4.2, 4.2, 0.3) if speaker in held_out else (4.2, 0.3, 0.3)
        for utterance, seconds in enumerate(lengths):
            name = f'{speaker}_100_{utterance:06d}_000000'
            folder = root / speaker / '100'
            _write_wav(folder / f'{name}.wav', rng, seconds=seconds,
                       sample_rate=8000)
            (folder / f'{name}.normalized.txt').write_text(name)


def _vctk_tree(data, rng):
    """17 speakers, so that the held-out cache indices 0013 and 0016
    exist, each with one short utterance at both microphones, but 0013
    with six 4.2 s utterances (twelve takes, two more than a held-out
    speaker's ten test utterances), 0016 with one and two others with one
    for validation"""
    root = data / 'vctk'
    for index in range(17):
        speaker = f'p{225 + index}'
        lengths = {13: (4.2,) * 6, 16: (4.2,), 2: (4.2,), 5: (4.2,)}.get(
            index, (0.3,))
        for utterance, seconds in enumerate(lengths, 1):
            stem = f'{speaker}_{utterance:03d}'
            for mic in (1, 2):
                _write_wav(
                    root / 'wav48_silence_trimmed' / speaker /
                    f'{stem}_mic{mic}.wav', rng, seconds=seconds,
                    sample_rate=8000)
            (root / 'txt' / speaker).mkdir(parents=True, exist_ok=True)
            (root / 'txt' / speaker / f'{stem}.txt').write_text(stem)


def test_partitions_of_the_formatted_caches(dirs, monkeypatch):
    """The port formats LibriTTS and VCTK, and both packages partition the
    port's caches. LibriTTS (through speakers.json) alike. VCTK (through
    correspondence.json): the same test utterances, and no other
    microphone's take of one in another split of the port's. The JAX
    package's reading of correspondence.json matches no stem (it appends
    '-100' to stems that carry it), so its train and valid splits keep
    those takes: they are the port's less nothing else"""
    config, _ = dirs
    rng = np.random.default_rng(3)
    _libritts_tree(config.DATA_DIR, rng)
    _vctk_tree(config.DATA_DIR, rng)
    port.data.download.datasets(['libritts', 'vctk'], config)
    monkeypatch.setattr(promonet_tpu, 'CACHE_DIR', config.CACHE_DIR)

    ours = port.partition.dataset('libritts', config=config)
    theirs = promonet_tpu.partition.dataset('libritts')
    assert json.dumps(ours) == json.dumps(theirs)
    assert port.partition.core.path('libritts', False, config).read_text() \
        == (promonet_tpu.ASSETS_DIR / 'partitions' / 'multispeaker' /
            'libritts.json').read_text()
    speakers = json.loads(
        (config.CACHE_DIR / 'libritts' / 'speakers.json').read_text())
    held_out = {
        f'{speakers[speaker][0]:04d}'
        for speaker in port.partition.core.ADAPTATION_SPEAKERS['libritts']}
    assert len(ours['test']) == 20
    assert {stem.split('/')[0] for stem in ours['test']} == held_out
    assert len(ours['valid']) == 4

    ours = port.partition.core._dataset_specific('vctk', False, config)
    theirs = promonet_tpu.partition.core._dataset_specific('vctk', False)
    correspondence = json.loads(
        (config.CACHE_DIR / 'vctk' / 'correspondence.json').read_text())
    assert ours['test'] == theirs['test']
    assert len(ours['test']) == 10 + 2
    tested = {correspondence[stem][:-1] for stem in ours['test']}
    # Takes of tested utterances that the test split does not hold
    others = {
        stem for stem, source in correspondence.items()
        if source[:-1] in tested and stem not in ours['test']}
    assert others
    assert not others & set(ours['train'] + ours['valid'])
    assert others <= set(theirs['train'] + theirs['valid'])
    assert sorted(ours['train'] + ours['valid']) == sorted(
        set(theirs['train'] + theirs['valid']) - others)
