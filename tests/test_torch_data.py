"""The port's data pipeline held against the JAX package's: the
formant-synthesis corpus, its preprocessing, the partitions and the
Dataset; the variable pitch bins computed over a corpus of another name
(equal to the JAX package's quantiles to the bit, cached under
CACHE_DIR.parent/stats); and a check that the port writes nothing into
the JAX package.

Both packages make the corpus (3 speakers x 4 utterances x 0.6 s) from
the same seed, in directories of their own; the port preprocesses with
the JAX package's shipped pitch CNN and PPG encoder carried over by the
bridge. Tolerances: the corpus (waveforms, labels, true pitch, voicing,
transcripts, partition JSON) is equal to the byte; partitions and
Dataset stems and speaker maps are equal; the preprocessed features are
held as the preprocessing parity test holds them (loudness within 1e-2
dB, pitch 1e-4 relative, periodicity and PPG within 1e-4), the linear
spectrogram within 1e-5 of its peak.
"""
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

import promonet_tpu
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from test_torch_train import drop_large_files

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(speakers=3, utterances=4, seconds=0.6)
FEATURE_FILES = (
    '-loudness.npy', '-viterbi-pitch.npy', '-viterbi-periodicity.npy',
    '-spectrogram.npy', '-ppg.npy')


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    """The JAX package's corpus and the port's, made from one seed"""
    root = tmp_path_factory.mktemp('data')
    assets = root / 'assets'
    assets.mkdir()
    for name in ('checkpoints', 'stats'):
        os.symlink(ROOT / 'promonet_tpu' / 'assets' / name, assets / name)
    jax_dirs = dict(CACHE_DIR=root / 'jax' / 'cache', ASSETS_DIR=assets)
    with pytest.MonkeyPatch.context() as patch:
        for name, value in jax_dirs.items():
            patch.setattr(promonet_tpu, name, value)
        promonet_tpu.data.synthetic.create('synthetic', **SHAPE)
        pitch_model = port.preprocess.PitchCNN()
        pitch_model.load_state_dict(bridge.pitch_state_dict(
            jax.device_get(jax_pitch.PitchCNN.instance().params)))
        ppg_model = port.preprocess.PPGEncoder()
        ppg_model.load_state_dict(bridge.ppg_state_dict(
            jax.device_get(jax_ppg._model()[1])))
    config = port.config.load().replace(
        CACHE_DIR=root / 'port' / 'cache',
        PARTITIONS_DIR=root / 'port' / 'partitions',
        RUNS_DIR=root / 'port' / 'runs')
    port.data.synthetic.create(
        'synthetic', **SHAPE, pitch_model=pitch_model, ppg_model=ppg_model,
        config=config, device='cpu')
    return root, jax_dirs, config


@pytest.fixture
def jax_dirs(corpora, monkeypatch):
    """The JAX package pointed at its corpus and its partitions"""
    _, dirs, _ = corpora
    for name, value in dirs.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    return dirs


def _stems(cache):
    return sorted(
        str(path.relative_to(cache))[:-len('.wav')]
        for path in cache.glob('*/*.wav'))


###############################################################################
# The corpus
###############################################################################


def test_corpus_matches_jax(corpora, jax_dirs):
    _, _, config = corpora
    theirs = jax_dirs['CACHE_DIR'] / 'synthetic'
    ours = config.CACHE_DIR / 'synthetic'
    stems = _stems(theirs)
    assert stems == _stems(ours) and len(stems) == 12
    for stem in stems:
        for suffix in ('.wav', '.txt', '-phonemes.npy', '-truepitch.npy',
                       '-voiced.npy'):
            assert (ours / f'{stem}{suffix}').read_bytes() == \
                (theirs / f'{stem}{suffix}').read_bytes(), stem + suffix
    assert (config.PARTITIONS_DIR / 'multispeaker' / 'synthetic.json'
            ).read_bytes() == (
        jax_dirs['ASSETS_DIR'] / 'partitions' / 'multispeaker' /
        'synthetic.json').read_bytes()
    # One file per feature, nothing else
    assert sorted(path.name[len('000000-100'):] for path in (
        ours / '0000').glob('000000-100*')) == sorted(
        ('.wav', '.txt', '-phonemes.npy', '-truepitch.npy', '-voiced.npy') +
        FEATURE_FILES)


def test_corpus_features_match_jax(corpora, jax_dirs):
    _, _, config = corpora
    theirs = jax_dirs['CACHE_DIR'] / 'synthetic'
    ours = config.CACHE_DIR / 'synthetic'
    for stem in _stems(theirs):
        frames = np.load(theirs / f'{stem}-phonemes.npy').shape[-1]
        for suffix in FEATURE_FILES:
            expected = np.load(theirs / f'{stem}{suffix}')
            value = np.load(ours / f'{stem}{suffix}')
            assert value.dtype == expected.dtype == np.float32
            assert value.shape == expected.shape and \
                value.shape[-1] == frames, stem + suffix
            tolerance = {
                '-loudness.npy': dict(rtol=0, atol=1e-2),
                '-viterbi-pitch.npy': dict(rtol=1e-4),
                '-spectrogram.npy': dict(
                    rtol=0, atol=1e-5 * np.abs(expected).max())}.get(
                suffix, dict(rtol=0, atol=1e-4))
            np.testing.assert_allclose(
                value, expected, err_msg=stem + suffix, **tolerance)


def test_synthesis_matches_jax():
    """The synthesizer alone, with the harmonic-stack generator"""
    for seed in (0, 1):
        ours = port.data.synthetic.generate_aligned_utterance(
            np.random.default_rng(seed), seconds=0.8)
        theirs = promonet_tpu.data.synthetic.generate_aligned_utterance(
            np.random.default_rng(seed), seconds=0.8)
        assert ours[1] == theirs[1]
        for a, b in zip(ours[:1] + ours[2:], theirs[:1] + theirs[2:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        port.data.synthetic.generate_utterance(np.random.default_rng(2)),
        promonet_tpu.data.synthetic.generate_utterance(
            np.random.default_rng(2)))


###############################################################################
# Partitions and the Dataset
###############################################################################


@pytest.mark.parametrize('adapt', [False, True])
def test_generic_partitions_match_jax(corpora, jax_dirs, adapt, tmp_path,
                                      monkeypatch):
    _, _, config = corpora
    # Each package writes into a directory of its own for this test
    monkeypatch.setattr(promonet_tpu, 'ASSETS_DIR', tmp_path / 'jax')
    config = config.replace(PARTITIONS_DIR=tmp_path / 'port')
    write = (
        (lambda package, **kwargs: package.partition.adaptation_partitions(
            'synthetic', 2, **kwargs)) if adapt else
        (lambda package, **kwargs: package.partition.dataset(
            'synthetic', **kwargs)))
    # The JAX package partitions its corpus, the port its own
    theirs = write(promonet_tpu)
    ours = write(port, config=config)
    assert ours == theirs and set(ours) == (
        {f'{kind}-adapt-{i:02d}' for kind in ('train', 'test')
         for i in range(3)} if adapt else {'train', 'valid', 'test'})
    assert port.load.partition('synthetic', adapt, config) == \
        promonet_tpu.load.partition('synthetic', adapt) == theirs


@pytest.mark.parametrize('name,adapt', [
    ('daps', False), ('daps', True), ('libritts', True), ('vctk', False),
    ('vctk', True)])
def test_published_partitions_match_jax(corpora, jax_dirs, name, adapt,
                                        tmp_path):
    _, _, config = corpora
    config = config.replace(PARTITIONS_DIR=tmp_path)
    theirs = promonet_tpu.partition.dataset(name, adapt)
    # Without a partition file of its own, the port reads the shipped one
    assert port.load.partition(name, adapt, config) == theirs
    assert port.partition.dataset(name, adapt, config) == theirs
    assert json.loads((tmp_path / (
        'adaptation' if adapt else 'multispeaker') / f'{name}.json'
    ).read_text()) == promonet_tpu.load.partition(name, adapt)
    assert theirs and all(
        stem.endswith('-100') for stems in theirs.values() for stem in stems)


def test_unknown_dataset_has_no_partition(corpora):
    _, _, config = corpora
    with pytest.raises(FileNotFoundError):
        port.load.partition('nothing', False, config)
    with pytest.raises(FileNotFoundError, match='No cached audio'):
        port.partition.dataset('nothing', config=config)


@pytest.mark.parametrize('partition', ['train', 'valid', 'test'])
def test_dataset_matches_jax(corpora, jax_dirs, partition):
    _, _, config = corpora
    theirs = promonet_tpu.data.Dataset('synthetic', partition)
    # The port's Dataset over the JAX package's corpus, with the port's
    # partition of its own corpus
    ours = port.data.Dataset('synthetic', partition, config.replace(
        CACHE_DIR=jax_dirs['CACHE_DIR']))
    assert ours.stems == theirs.stems and len(ours) == len(theirs)
    assert ours.speaker_index == theirs.speaker_index
    # Training stems have augmented variants in the shipped ratio files
    assert any('-p' in stem for stem in ours.stems) == (
        partition == 'train')
    original = [i for i, stem in enumerate(ours.stems)
                if stem.endswith('-100')]
    item, expected = ours[original[-1]], theirs.load_item(original[-1])
    assert set(item) == set(expected)
    for key, value in expected.items():
        if isinstance(value, str):
            assert item[key] == value, key
        else:
            assert item[key].dtype == value.dtype, key
            np.testing.assert_array_equal(item[key], value, err_msg=key)


def test_dataset_drops_mains_hum(corpora, tmp_path):
    _, _, config = corpora
    cache = tmp_path / 'cache' / 'hum'
    (cache / '0000').mkdir(parents=True)
    for stem, hz in (('000000-100', 50.), ('000001-100', 120.)):
        np.save(cache / '0000' / f'{stem}-viterbi-pitch.npy',
                np.full((1, 10), hz, np.float32))
    config = config.replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions')
    port.partition.core.write(
        {'test': ['0000/000000-100', '0000/000001-100']}, 'hum', False,
        config)
    assert port.data.Dataset('hum', 'test', config).stems == [
        '0000/000001-100']


###############################################################################
# The variable pitch bins
###############################################################################


@pytest.fixture(scope='module')
def quantile_corpus(tmp_path_factory):
    """A port corpus (2 speakers x 4 utterances x 1 s) under a name with no
    shipped statistics, preprocessed with the shipped extractors, and its
    configuration"""
    root = tmp_path_factory.mktemp('quantiles')
    config = port.config.load().replace(
        CACHE_DIR=root / 'data' / 'cache',
        PARTITIONS_DIR=root / 'data' / 'partitions',
        CHECKPOINTS_DIR=root / 'checkpoints', RUNS_DIR=root / 'runs',
        TRAINING_DATASET='quantiles')
    port.data.synthetic.create(
        'quantiles', speakers=2, utterances=4, seconds=1.0, config=config,
        device='cpu')
    return config


def _shipped_stats():
    stats = ROOT / 'promonet_tpu' / 'assets' / 'stats'
    return {path.name: path.read_bytes() for path in stats.iterdir()}


def test_pitch_bins_are_computed_as_jax_computes_them(
        quantile_corpus, tmp_path, monkeypatch):
    """Without shipped statistics the bins are the quantiles the JAX
    package computes over the same cache, written under
    CACHE_DIR.parent/stats and nowhere else, and read from there
    afterwards"""
    config = quantile_corpus
    shipped = _shipped_stats()
    # The JAX package over the port's cache, with a copy of its partition
    assets = tmp_path / 'assets'
    (assets / 'partitions' / 'multispeaker').mkdir(parents=True)
    (assets / 'partitions' / 'multispeaker' / 'quantiles.json').write_bytes(
        (config.PARTITIONS_DIR / 'multispeaker' / 'quantiles.json'
         ).read_bytes())
    for name, value in dict(
            CACHE_DIR=config.CACHE_DIR, DATA_DIR=tmp_path / 'datasets',
            ASSETS_DIR=assets).items():
        monkeypatch.setattr(promonet_tpu, name, value)
    expected = promonet_tpu.load._compute_pitch_distribution(
        'quantiles', 'train')

    ours = port.load.pitch_distribution(config)
    assert ours.dtype == expected.dtype == np.float32
    assert ours.shape == (config.PITCH_BINS,)
    np.testing.assert_array_equal(ours, expected)
    np.testing.assert_array_equal(
        ours, promonet_tpu.load.pitch_distribution('quantiles'))
    assert not np.array_equal(ours, port.load.pitch_distribution(
        config, dataset='absent'))
    np.testing.assert_array_equal(
        port.models.Generator(config.replace(
            HIFIGAN_UPSAMPLE_INITIAL_SIZE=32)).pitch_distribution.numpy(),
        expected)

    # Written once, atomically, beside the cache
    stats = config.CACHE_DIR.parent / 'stats'
    name = 'quantiles-256-loudness-pitch-viterbi.npy'
    assert sorted(path.name for path in stats.iterdir()) == [name]
    np.testing.assert_array_equal(np.load(stats / name), expected)
    assert _shipped_stats() == shipped

    # Another process reads the file without touching the dataset
    computed = []
    monkeypatch.setattr(port.load.pitch_distribution, 'cache', {})
    monkeypatch.setattr(
        port.load, '_compute_pitch_distribution',
        lambda *args: computed.append(args))
    np.testing.assert_array_equal(port.load.pitch_distribution(
        config, dataset='quantiles', partition='train'), expected)
    assert computed == []


def test_pitch_bins_fall_back_where_jax_falls_back(
        quantile_corpus, tmp_path, monkeypatch):
    """No cache of the dataset: the log-uniform bins of the JAX package,
    nothing written; the file the JAX package ships is read first"""
    config = quantile_corpus
    shipped = _shipped_stats()
    monkeypatch.setattr(promonet_tpu, 'ASSETS_DIR', tmp_path / 'assets')
    monkeypatch.setattr(promonet_tpu, 'CACHE_DIR', tmp_path / 'cache')
    np.testing.assert_array_equal(
        port.load.pitch_distribution(config, dataset='absent'),
        promonet_tpu.load.pitch_distribution('absent'))
    assert not (config.CACHE_DIR.parent / 'stats' /
                'absent-256-loudness-pitch-viterbi.npy').exists()
    # The shipped file goes before a file of the port's own
    name = 'synthetic-256-loudness-pitch-viterbi.npy'
    (tmp_path / 'data' / 'stats').mkdir(parents=True)
    np.save(tmp_path / 'data' / 'stats' / name, np.zeros(256, np.float32))
    np.testing.assert_array_equal(
        port.load.pitch_distribution(
            config.replace(CACHE_DIR=tmp_path / 'data' / 'cache'),
            dataset='synthetic'),
        np.load(ROOT / 'promonet_tpu' / 'assets' / 'stats' / name))
    assert _shipped_stats() == shipped


###############################################################################
# The JAX package stays untouched
###############################################################################


def _jax_package_files():
    package = ROOT / 'promonet_tpu'
    return sorted(
        str(path.relative_to(package)) for path in package.rglob('*')
        if path.is_file() and '__pycache__' not in path.parts)


def _jax_runs():
    """Every file under the JAX package's run directory, with its size"""
    runs = ROOT / 'runs' / 'promonet'
    return sorted(
        (str(path.relative_to(runs)), path.stat().st_size)
        for path in runs.rglob('*') if path.is_file())


def test_port_never_writes_into_the_jax_package(tmp_path, monkeypatch):
    """The corpus, its partition and an evaluation at the defaults, then
    augmentation, training, speaker adaptation, a step of the pitch CNN's
    and of the PPG encoder's training and the per-speaker averages, with
    only the directories the port writes pointed at a temporary one; the
    generator is narrowed to the width the parity tests use, and training
    to a chunk of 2048 samples, which moves no file. Training runs
    without TensorBoard, as in `test_torch_train_runs.py`"""
    monkeypatch.setattr(
        port.utils.log, '_tensorboard_writer', lambda directory: None)
    try:
        _run_everything_that_writes(tmp_path)
    finally:
        drop_large_files(tmp_path)


def _run_everything_that_writes(tmp_path):
    shipped = ROOT / 'promonet_tpu' / 'assets' / 'partitions' / \
        'multispeaker' / 'synthetic.json'
    augmentations = ROOT / 'promonet_tpu' / 'assets' / 'augmentations'
    before = (
        shipped.read_bytes(), _jax_package_files(), _jax_runs(),
        {path.name: path.read_bytes() for path in augmentations.iterdir()})
    config = port.config.load().replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        EVAL_DIR=tmp_path / 'eval', RESULTS_DIR=tmp_path / 'results',
        AUGMENT_DIR=tmp_path / 'augmentations', RUNS_DIR=tmp_path / 'runs',
        CHECKPOINTS_DIR=tmp_path / 'checkpoints',
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=1,
        DEFAULT_EVALUATION_STEPS=1, STEPS=0, ADAPTATION_STEPS=1)
    port.data.synthetic.create(
        speakers=1, utterances=3, seconds=0.5, config=config, device='cpu')
    port.partition.dataset('synthetic', config=config)
    results = port.evaluate.datasets(
        ['synthetic'], config=config, device='cpu')
    assert len(results['synthetic']['objective']) == 11

    port.data.augment.datasets(['synthetic'], config)
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    run = config.RUNS_DIR / config.CONFIG
    port.train(run, 'synthetic', steps=1, config=config, device='cpu')
    wavs = sorted((config.CACHE_DIR / 'synthetic' / '0000').glob('*-100.wav'))
    port.adapt.speaker(
        'voice', wavs + wavs[:2], checkpoint=run / 'generator-00000001.pt',
        config=config, device='cpu')
    assert (config.RUNS_DIR / 'voice' / 'generator-00000002.pt').exists()
    port.preprocess.pitch.train(
        steps=1, batch_size=2, max_frames=50, config=config, device='cpu')
    port.preprocess.ppg.train(
        steps=1, batch_size=2, window=32, config=config, device='cpu')
    assert set(port.load.per_speaker_averages(
        'synthetic', config=config)) == {'0000'}

    assert (
        shipped.read_bytes(), _jax_package_files(), _jax_runs(),
        {path.name: path.read_bytes() for path in augmentations.iterdir()}
    ) == before
    written = {path.relative_to(tmp_path).parts[0]
               for path in tmp_path.rglob('*') if path.is_file()}
    assert written == {
        'cache', 'partitions', 'eval', 'results', 'augmentations', 'runs',
        'checkpoints', 'stats'}
    defaults = port.config.load()
    assert all(
        str(getattr(defaults, name)).startswith(str(ROOT / 'data'))
        for name in ('CACHE_DIR', 'PARTITIONS_DIR', 'EVAL_DIR', 'RESULTS_DIR',
                     'AUGMENT_DIR'))
    assert defaults.RUNS_DIR == ROOT / 'runs_torch'


def test_directories_given_as_strings_are_paths(tmp_path):
    config = port.config.load().replace(
        CACHE_DIR=str(tmp_path), EVALUATION_RATIOS=[1.5])
    assert config.CACHE_DIR == tmp_path
    assert isinstance(config.PARTITIONS_DIR, Path)
    assert config.EVALUATION_RATIOS == [1.5]
