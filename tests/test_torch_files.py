"""The port's file-level entry points and their IO held against the JAX
package's.

Wav files are read and written by both packages and must give the same
samples; feature arrays cross in both directions as `.npy` and `.pt`.
Every `*_to_file` function must write the same set of file names as its
JAX counterpart in a directory of its own, and the arrays it writes must
equal the port's in-memory results for the same input. `load.ppg`'s
resampling is held to 1e-6 of the JAX package's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import promonet_tpu
import promonet_tpu.synthesize.core as jax_synthesize_core

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

SAMPLE_RATE = 22050


def _harmonic_audio(seconds):
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def _names(directory):
    return sorted(path.name for path in Path(directory).iterdir())


def _wav(directory, seconds=0.5, name='speech.wav'):
    file = Path(directory) / name
    port.utils.audio.save(file, _harmonic_audio(seconds), SAMPLE_RATE)
    return file


@pytest.fixture(scope='module')
def front_ends():
    """Seeded pitch CNN and PPG encoder: the file functions' outputs are
    held against the port's own in-memory results"""
    return (port.models.init.seeded(port.preprocess.PitchCNN(), 1),
            port.models.init.seeded(port.preprocess.PPGEncoder(), 2))


###############################################################################
# Wav files and arrays
###############################################################################


@pytest.mark.parametrize('kind', ['int16', 'int32', 'uint8', 'float32',
                                  'stereo', 'resampled'])
def test_wav_load_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    data = rng.uniform(-0.9, 0.9, 1000)
    rate, target = 22050, None
    written = {
        'int16': (data * 32767).astype(np.int16),
        'int32': (data * 2 ** 31).astype(np.int32),
        'uint8': (128 + data * 127).astype(np.uint8),
        'float32': data.astype(np.float32),
        'stereo': np.stack([data, -0.5 * data], 1).astype(np.float32),
        'resampled': (data * 32767).astype(np.int16)}[kind]
    if kind == 'resampled':
        rate, target = 44100, 22050
    file = tmp_path / 'x.wav'
    wavfile.write(file, rate, written)
    ours, our_rate = port.utils.audio.load(file, target)
    theirs, their_rate = promonet_tpu.utils.audio.load(file, target)
    assert our_rate == their_rate == (target or rate)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    if kind not in ('float32', 'stereo'):
        # The header reader takes integer PCM only, in both packages
        assert port.utils.audio.duration(file) == \
            promonet_tpu.utils.audio.duration(file) == len(written) / rate


def test_wav_save_matches_jax(tmp_path):
    audio = 1.2 * _harmonic_audio(0.1)
    port.utils.audio.save(tmp_path / 'ours.wav', audio, SAMPLE_RATE)
    promonet_tpu.utils.audio.save(tmp_path / 'theirs.wav', audio, SAMPLE_RATE)
    assert (tmp_path / 'ours.wav').read_bytes() == \
        (tmp_path / 'theirs.wav').read_bytes()
    # A (T,) vector and a (1, T) row give the same file
    port.utils.audio.save(tmp_path / 'vector.wav', audio[0], SAMPLE_RATE)
    assert (tmp_path / 'vector.wav').read_bytes() == \
        (tmp_path / 'ours.wav').read_bytes()
    loaded = port.load.audio(tmp_path / 'ours.wav')
    np.testing.assert_array_equal(
        loaded, promonet_tpu.load.audio(tmp_path / 'ours.wav'))
    assert np.abs(loaded - np.clip(audio, -1, 1)).max() < 1e-4


@pytest.mark.parametrize('suffix', ['.npy', '.pt'])
def test_arrays_cross_between_the_packages(tmp_path, suffix):
    value = np.random.default_rng(1).standard_normal((3, 17)).astype(
        np.float32)
    port.load.save_array(tmp_path / f'ours{suffix}', torch.from_numpy(value))
    promonet_tpu.load.save_array(tmp_path / f'theirs{suffix}', value)
    assert _names(tmp_path) == sorted([f'ours{suffix}', f'theirs{suffix}'])
    for name in ('ours', 'theirs'):
        for load in (port.load.array, promonet_tpu.load.array):
            np.testing.assert_array_equal(
                load(tmp_path / f'{name}{suffix}'), value)


def test_array_reads_the_npy_sibling_and_refuses_a_missing_file(tmp_path):
    value = np.arange(6.).reshape(2, 3)
    port.load.save_array(tmp_path / 'x.pitch', value)
    assert _names(tmp_path) == ['x.npy']
    np.testing.assert_array_equal(port.load.array(tmp_path / 'x.pt'), value)
    with pytest.raises(FileNotFoundError):
        port.load.array(tmp_path / 'y.pt')


@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('frames,length', [(40, 57), (57, 40), (40, 40)])
def test_ppg_resampling_matches_jax(tmp_path, monkeypatch, method, frames,
                                    length):
    """Within 1e-6 on the JAX package's grid

    `jnp.linspace` and `torch.linspace` build the grid by other float32
    arithmetic (XLA turns the division into a multiplication); the two
    grids are at most one float32 step apart, and on the port's own grid
    a frame may move by that step times the PPG's largest change between
    neighbouring frames.
    """
    monkeypatch.setattr(promonet_tpu, 'PPG_INTERP_METHOD', method)
    logits = 3 * np.random.default_rng(frames).standard_normal((40, frames))
    ppg = (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)
    file = tmp_path / 'x-ppg.npy'
    np.save(file, ppg)
    config = port.config.load().replace(PPG_INTERP_METHOD=method)
    theirs = promonet_tpu.load.ppg(file, length)
    ours = port.load.ppg(file, length, config, device='cpu').numpy()
    assert ours.shape == theirs.shape == (40, length)
    np.testing.assert_allclose(ours.sum(0), 1., atol=1e-5)

    their_grid = np.array(promonet_tpu.ops.grid.of_length(ppg, length))
    our_grid = port.ops.grid.of_length(torch.from_numpy(ppg), length)
    step = np.spacing(np.float32(frames))
    assert np.abs(our_grid.numpy() - their_grid).max() <= step
    bound = 1e-6 + step * np.abs(np.diff(ppg, axis=-1)).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=bound)

    monkeypatch.setattr(
        port.ops.grid, 'of_length',
        lambda tensor, length: torch.from_numpy(their_grid))
    np.testing.assert_allclose(
        port.load.ppg(file, length, config, 'cpu').numpy(), theirs, rtol=0,
        atol=1e-6)


@pytest.mark.parametrize('viterbi', [True, False])
def test_features_and_text_match_jax(tmp_path, monkeypatch, viterbi):
    monkeypatch.setattr(promonet_tpu, 'VITERBI_DECODE_PITCH', viterbi)
    infix = '-viterbi' if viterbi else ''
    rng = np.random.default_rng(2)
    for name in ('-loudness', f'{infix}-pitch', f'{infix}-periodicity',
                 '-ppg'):
        np.save(tmp_path / f'x{name}.npy', rng.standard_normal((2, 5)))
    config = port.config.load().replace(VITERBI_DECODE_PITCH=viterbi)
    for a, b in zip(port.load.features(tmp_path / 'x', config),
                    promonet_tpu.load.features(tmp_path / 'x')):
        np.testing.assert_array_equal(a, b)
    (tmp_path / 'x.txt').write_text('Größe — text', encoding='utf-8')
    assert port.load.text(tmp_path / 'x.txt') == \
        promonet_tpu.load.text(tmp_path / 'x.txt') == 'Größe — text'


###############################################################################
# Preprocess, pitch and harmonics from files
###############################################################################


@pytest.mark.parametrize('features,viterbi', [
    (('loudness', 'pitch', 'periodicity', 'ppg'), True),
    (('loudness', 'pitch', 'periodicity', 'ppg'), False),
    (('pitch', 'harmonics'), True)])
def test_preprocess_to_file_matches_jax(
    tmp_path, monkeypatch, front_ends, features, viterbi
):
    monkeypatch.setattr(promonet_tpu, 'VITERBI_DECODE_PITCH', viterbi)
    config = port.config.load().replace(VITERBI_DECODE_PITCH=viterbi)
    file = _wav(tmp_path, 0.3)
    (tmp_path / 'ours').mkdir()
    (tmp_path / 'theirs').mkdir()
    port.preprocess.from_file_to_file(
        file, *front_ends, tmp_path / 'ours' / 'speech', features=features,
        config=config, device='cpu')
    promonet_tpu.preprocess.from_file_to_file(
        file, tmp_path / 'theirs' / 'speech', features=features)
    assert _names(tmp_path / 'ours') == _names(tmp_path / 'theirs')
    expected = port.preprocess.from_file(
        file, *front_ends, features=features, config=config, device='cpu')
    for name, value in zip(features, expected):
        if viterbi and name in ('pitch', 'periodicity'):
            name = f'viterbi-{name}'
        np.testing.assert_array_equal(
            np.load(tmp_path / 'ours' / f'speech-{name}.npy'), value.numpy())


def test_preprocess_files_to_files_names_each_output(tmp_path, front_ends):
    files = [_wav(tmp_path, 0.2, f'{name}.wav') for name in ('a', 'b')]
    port.preprocess.from_files_to_files(
        files, *front_ends, features=('loudness',), device='cpu')
    assert _names(tmp_path) == [
        'a-loudness.npy', 'a.wav', 'b-loudness.npy', 'b.wav']
    for file in files:
        np.testing.assert_array_equal(
            np.load(file.with_name(f'{file.stem}-loudness.npy')),
            port.preprocess.from_file(
                file, None, None, features=('loudness',),
                device='cpu')[0].numpy())


def test_pitch_to_file_matches_jax(tmp_path, front_ends):
    file = _wav(tmp_path, 0.3)
    (tmp_path / 'ours').mkdir()
    (tmp_path / 'theirs').mkdir()
    port.preprocess.pitch.from_file_to_file(
        file, tmp_path / 'ours' / 'speech', front_ends[0], device='cpu')
    promonet_tpu.preprocess.pitch.from_file_to_file(
        file, tmp_path / 'theirs' / 'speech')
    assert _names(tmp_path / 'ours') == _names(tmp_path / 'theirs') == [
        'speech-viterbi-periodicity.npy', 'speech-viterbi-pitch.npy']
    pitch, periodicity = port.preprocess.pitch.from_file(
        file, front_ends[0], device='cpu')
    np.testing.assert_array_equal(
        np.load(tmp_path / 'ours' / 'speech-viterbi-pitch.npy'), pitch.numpy())
    np.testing.assert_array_equal(
        np.load(tmp_path / 'ours' / 'speech-viterbi-periodicity.npy'),
        periodicity.numpy())


def test_harmonics_to_file_matches_jax(tmp_path):
    """With a saved F0 contour, as `pitch_file`"""
    files = [_wav(tmp_path, 0.25, f'{name}.wav') for name in ('a', 'b')]
    frames = int(0.25 * SAMPLE_RATE) // 256
    pitch_file = tmp_path / 'a-pitch.npy'
    np.save(pitch_file, np.full((1, frames), 180., np.float32))
    outputs = [tmp_path / f'{name}-harmonics.npy' for name in ('a', 'b')]
    port.preprocess.harmonics.from_files_to_files(
        files, outputs, [pitch_file, None], device='cpu')
    theirs = tmp_path / 'theirs-harmonics.npy'
    promonet_tpu.preprocess.harmonics.from_file_to_file(
        files[0], theirs, pitch_file)
    expected = port.preprocess.harmonics.from_file(
        files[0], pitch_file, device='cpu').numpy()
    written = np.load(outputs[0])
    assert written.shape == np.load(theirs).shape == (3, frames)
    np.testing.assert_array_equal(written, expected)
    np.testing.assert_array_equal(written[0], 180.)
    np.testing.assert_array_equal(
        np.load(outputs[1]),
        port.preprocess.harmonics.from_file(files[1], device='cpu').numpy())


###############################################################################
# Edit and synthesize from files
###############################################################################


def _feature_files(directory, frames=50, ppg_frames=None, seed=3):
    """Loudness, pitch, periodicity and PPG files of one utterance"""
    rng = np.random.default_rng(seed)
    ppg_frames = frames if ppg_frames is None else ppg_frames
    logits = 2 * rng.standard_normal((40, ppg_frames))
    values = {
        'loudness': rng.uniform(-80, 10, (8, frames)),
        'viterbi-pitch': 150 + 30 * rng.random((1, frames)),
        'viterbi-periodicity': rng.random((1, frames)),
        'ppg': np.exp(logits) / np.exp(logits).sum(0)}
    files = []
    for name, value in values.items():
        files.append(Path(directory) / f'in-{name}.npy')
        np.save(files[-1], value.astype(np.float32))
    return files


@pytest.mark.parametrize('save_grid,stretch_unvoiced', [
    (True, True), (True, False), (False, True)])
def test_edit_to_file_matches_jax(tmp_path, save_grid, stretch_unvoiced):
    """The PPG file has another frame count and is resampled on reading"""
    inputs = _feature_files(tmp_path, ppg_frames=61)
    (tmp_path / 'ours').mkdir()
    (tmp_path / 'theirs').mkdir()
    kwargs = dict(pitch_shift_cents=200., time_stretch_ratio=1.3,
                  loudness_scale_db=-2., stretch_unvoiced=stretch_unvoiced,
                  save_grid=save_grid)
    port.edit.from_file_to_file(
        *inputs, tmp_path / 'ours' / 'edited', device='cpu', **kwargs)
    promonet_tpu.edit.from_file_to_file(
        *inputs, tmp_path / 'theirs' / 'edited', **kwargs)
    names = _names(tmp_path / 'ours')
    assert names == _names(tmp_path / 'theirs')
    assert ('edited-grid.npy' in names) == save_grid
    kwargs['return_grid'] = kwargs.pop('save_grid')
    expected = port.edit.from_file(*inputs, device='cpu', **kwargs)
    for name, value in zip(
        ('loudness', 'viterbi-pitch', 'viterbi-periodicity', 'ppg', 'grid'),
        expected
    ):
        np.testing.assert_array_equal(
            np.load(tmp_path / 'ours' / f'edited-{name}.npy'), value.numpy())
        # and within float32 sum order of the JAX package's
        np.testing.assert_allclose(
            np.load(tmp_path / 'ours' / f'edited-{name}.npy'),
            np.load(tmp_path / 'theirs' / f'edited-{name}.npy'),
            rtol=1e-4, atol=1e-4)


def test_edit_files_to_files_names_each_output(tmp_path):
    inputs = [_feature_files(tmp_path, seed=seed) for seed in (4, 5)]
    prefixes = [tmp_path / 'out' / name for name in ('a', 'b')]
    (tmp_path / 'out').mkdir()
    port.edit.from_files_to_files(
        *zip(*inputs), prefixes, pitch_shift_cents=-100., device='cpu')
    assert _names(tmp_path / 'out') == sorted(
        f'{name}-{feature}.npy' for name in ('a', 'b') for feature in (
            'loudness', 'viterbi-pitch', 'viterbi-periodicity', 'ppg'))
    np.testing.assert_array_equal(
        np.load(tmp_path / 'out' / 'b-viterbi-pitch.npy'),
        port.edit.from_file(
            *inputs[1], pitch_shift_cents=-100., device='cpu')[1].numpy())


def test_synthesize_to_file_matches_jax(tmp_path, monkeypatch):
    """A narrow float32 generator with the same weights on both sides"""
    monkeypatch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', 16)
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 64)), jnp.full((1, 64), 100.),
        jnp.zeros((1, 64)), jnp.full((1, 40, 64), 1 / 40),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), jnp.ones((1,))))
    monkeypatch.setattr(
        jax_synthesize_core._cached_model, 'cache',
        {'narrow': (jax_model, params, jax.jit(jax_model.apply))},
        raising=False)
    generator = port.models.Generator(port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=16, PRECISION='float32'))
    generator.load_state_dict(bridge.generator_state_dict(params))

    inputs = [_feature_files(tmp_path, 40, 47, seed) for seed in (6, 7)]
    (tmp_path / 'ours').mkdir()
    (tmp_path / 'theirs').mkdir()
    outputs = [tmp_path / 'ours' / f'{name}.wav' for name in ('a', 'b')]
    port.synthesize.from_files_to_files(
        *zip(*inputs), outputs, generator, speakers=[3, 5], device='cpu')
    promonet_tpu.synthesize.from_file_to_file(
        *inputs[1], tmp_path / 'theirs' / 'b.wav', speaker=5,
        checkpoint='narrow')
    assert _names(tmp_path / 'ours') == ['a.wav', 'b.wav']
    assert _names(tmp_path / 'theirs') == ['b.wav']
    expected = port.synthesize.from_file(
        *inputs[1], generator, speaker=5, device='cpu')
    assert expected.shape == (1, 40 * 256)
    port.utils.audio.save(tmp_path / 'expected.wav', expected, SAMPLE_RATE)
    assert outputs[1].read_bytes() == (tmp_path / 'expected.wav').read_bytes()
    ours, theirs = (
        promonet_tpu.utils.audio.load(file)[0]
        for file in (outputs[1], tmp_path / 'theirs' / 'b.wav'))
    # One 16-bit step, or 1e-3 of the peak where float32 sum order moves
    # a sample across a step
    assert np.abs(ours - theirs).max() <= max(
        1 / 32768 + 1e-7, 1e-3 * np.abs(theirs).max())


def test_file_entry_points_refuse_a_missing_gpu(tmp_path, front_ends):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the refusal is for hosts without one')
    file = _wav(tmp_path, 0.1)
    features = _feature_files(tmp_path, 10)
    for function in (
        lambda: port.preprocess.from_file(file, *front_ends),
        lambda: port.preprocess.from_file_to_file(file, *front_ends),
        lambda: port.preprocess.pitch.from_file(file, front_ends[0]),
        lambda: port.preprocess.harmonics.from_file(file),
        lambda: port.edit.from_file(*features, pitch_shift_cents=100.),
        lambda: port.edit.from_file_to_file(
            *features, tmp_path / 'edited', pitch_shift_cents=100.),
        lambda: port.load.ppg(features[3], 12),
        lambda: port.synthesize.from_file(
            *features, port.models.Generator(
                port.config.load().replace(HIFIGAN_UPSAMPLE_INITIAL_SIZE=16))),
    ):
        with pytest.raises(RuntimeError, match='CUDA'):
            function()
    assert _names(tmp_path) == sorted(
        ['speech.wav'] + [f'in-{name}.npy' for name in (
            'loudness', 'viterbi-pitch', 'viterbi-periodicity', 'ppg')])
