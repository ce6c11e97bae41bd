"""The spectrogram-only baseline held against the JAX package's: the
'spectrogram' feature, `models.MelGenerator`, `baseline.mels` and the
evaluation's mels branch (configs/baselines/mels.py).

Weights are the JAX package's (shipped pitch CNN and PPG encoder; a
narrow float32 MelGenerator with random weights) carried over by the
bridge. Tolerances: the linear spectrogram within 1e-5 of its peak (both
are float32 FFT magnitudes of the same padded audio); MelGenerator's
audio within 1e-5 of its peak on the same spectrogram (the generator
parity tests see 2e-8 for `Generator`); in the whole evaluation the
exported features as the preprocessing parity test holds them (loudness
within 1e-2 dB, pitch 1e-4 relative, periodicity within 5e-4, PPG within
1e-4), the wav files within two 16-bit steps and results.json within
1e-4 relative.
"""
import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.baseline.mels as jax_mels
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 32
MELS_CONFIG = ROOT / 'configs' / 'baselines' / 'mels.py'


def _harmonic_audio(seconds=0.7):
    sr = promonet_tpu.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / sr
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    audio += 0.01 * np.random.default_rng(0).standard_normal(t.shape)
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


@pytest.fixture(scope='module')
def front_ends():
    pitch_model = port.preprocess.PitchCNN()
    pitch_model.load_state_dict(bridge.pitch_state_dict(
        jax.device_get(jax_pitch.PitchCNN.instance().params)))
    ppg_model = port.preprocess.PPGEncoder()
    ppg_model.load_state_dict(bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])))
    return pitch_model, ppg_model


def _mel_generator(monkeypatch, sparse_mels=False, threshold=None):
    """A JAX MelGenerator with random float32 weights, and the port's with
    the same weights"""
    monkeypatch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', WIDTH)
    monkeypatch.setattr(promonet_tpu, 'SPARSE_MELS', sparse_mels)
    monkeypatch.setattr(
        promonet_tpu, 'LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD',
        None if threshold is None else math.log(threshold))
    model = promonet_tpu.models.MelGenerator.create(dtype=jnp.float32)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.full((1, 513, 64), 1e-3),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), jnp.ones((1,))))
    config = port.config.load(MELS_CONFIG).replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH, PRECISION='float32',
        SPARSE_MELS=sparse_mels, DYNAMIC_RANGE_COMPRESSION_THRESHOLD=threshold)
    generator = port.models.MelGenerator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    return model, params, generator.eval()


###############################################################################
# The spectrogram feature
###############################################################################


def test_spectrogram_feature_matches_jax(front_ends):
    audio = _harmonic_audio()
    names = ('loudness', 'pitch', 'periodicity', 'spectrogram', 'ppg')
    theirs = [np.asarray(x) for x in promonet_tpu.preprocess.from_audio(
        audio, features=names, loudness_bands=None)]
    ours = port.preprocess.from_audio(
        audio, *front_ends, features=('ppg', 'spectrogram', 'loudness',
                                      'periodicity', 'pitch'),
        loudness_bands=None, device='cpu')
    # Returned in the JAX package's order, whatever order was asked
    assert [tuple(x.shape) for x in ours] == [x.shape for x in theirs]
    spectrogram = ours[3].numpy()
    assert spectrogram.shape == (513, audio.shape[-1] // 256)
    np.testing.assert_allclose(
        spectrogram, theirs[3], rtol=0, atol=1e-5 * theirs[3].max())
    np.testing.assert_allclose(ours[4].numpy(), theirs[4], rtol=0, atol=1e-4)
    # Asked alone it is the same array
    alone, = port.preprocess.from_audio(
        audio, None, None, features=('spectrogram',), device='cpu')
    np.testing.assert_array_equal(alone.numpy(), spectrogram)


def test_spectrogram_files_match_jax(front_ends, tmp_path):
    wav = tmp_path / 'speech.wav'
    port.utils.audio.save(wav, _harmonic_audio(0.4), 22050)
    port.preprocess.from_file_to_file(
        wav, *front_ends, tmp_path / 'ours',
        features=('spectrogram', 'pitch'), device='cpu')
    promonet_tpu.preprocess.from_file_to_file(
        wav, tmp_path / 'theirs', features=('spectrogram', 'pitch'))
    assert sorted(p.name for p in tmp_path.glob('ours*')) == [
        'ours-spectrogram.npy', 'ours-viterbi-pitch.npy']
    expected = np.load(tmp_path / 'theirs-spectrogram.npy')
    np.testing.assert_allclose(
        np.load(tmp_path / 'ours-spectrogram.npy'), expected, rtol=0,
        atol=1e-5 * expected.max())


###############################################################################
# MelGenerator and the baseline
###############################################################################


@pytest.mark.parametrize('sparse_mels,threshold', [
    (False, None), (True, 1e-5)])
def test_mel_generator_matches_jax(monkeypatch, sparse_mels, threshold):
    model, params, generator = _mel_generator(
        monkeypatch, sparse_mels, threshold)
    spectrogram = np.asarray(
        promonet_tpu.preprocess.spectrogram.from_audio(_harmonic_audio()))
    expected = np.asarray(jax.jit(model.apply)(
        params, spectrogram[None], jnp.asarray([2], jnp.int32),
        jnp.asarray([1.2]), jnp.asarray([0.9])))
    with torch.no_grad():
        audio = generator(
            torch.from_numpy(spectrogram)[None], torch.tensor([2]),
            torch.tensor([1.2]), torch.tensor([0.9])).numpy()
    assert audio.shape == expected.shape == (
        1, 1, spectrogram.shape[-1] * 256)
    np.testing.assert_allclose(
        audio, expected, rtol=0, atol=1e-5 * np.abs(expected).max())
    # No pitch embedding: the bridge maps every leaf
    assert not hasattr(generator, 'pitch_embed')


def test_baseline_matches_jax(monkeypatch, tmp_path):
    model, params, generator = _mel_generator(monkeypatch)
    monkeypatch.setattr(
        jax_mels, '_cached_model',
        lambda checkpoint: (model, params, jax.jit(model.apply)))
    audio = _harmonic_audio()
    spectrogram = np.asarray(
        promonet_tpu.preprocess.spectrogram.from_audio(audio))
    for ours, theirs in (
        (port.baseline.mels.from_features(
            spectrogram, generator, speaker=1, spectral_balance_ratio=1.1,
            device='cpu'),
         jax_mels.from_features(
             spectrogram, speaker=1, spectral_balance_ratio=1.1)),
        (port.baseline.mels.from_audio(audio, generator, device='cpu'),
         jax_mels.from_audio(audio)),
    ):
        assert ours.dtype == np.float32 and ours.shape == theirs.shape
        np.testing.assert_allclose(
            ours, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())
    # A port checkpoint of it, read back under the mels configuration
    port.utils.checkpoint.save(
        tmp_path / 'generator-00000001.pt', generator.state_dict(), step=1)
    loaded = port.load.generator(
        tmp_path / 'generator-00000001.pt', generator.config, 'cpu')
    assert isinstance(loaded, port.models.MelGenerator)
    for name, value in generator.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], value), name


def test_mel_generator_refuses_fargan():
    config = port.config.load(MELS_CONFIG).replace(MODEL='fargan')
    with pytest.raises(ValueError, match='FARGAN'):
        port.models.MelGenerator(config)


###############################################################################
# The evaluation's mels branch
###############################################################################


@pytest.fixture(scope='module')
def evaluations(tmp_path_factory):
    """Both packages' evaluation of one JAX-made corpus under the mels
    configuration: only 'reconstructed' runs"""
    root = tmp_path_factory.mktemp('mels')
    assets = root / 'assets'
    assets.mkdir()
    for name in ('checkpoints', 'stats'):
        os.symlink(ROOT / 'promonet_tpu' / 'assets' / name, assets / name)
    with pytest.MonkeyPatch.context() as patch:
        for name, value in dict(
                CACHE_DIR=root / 'cache', ASSETS_DIR=assets,
                RESULTS_DIR=root / 'jax' / 'results',
                EVAL_DIR=root / 'jax' / 'eval', RUNS_DIR=root / 'runs',
                HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH, EVALUATION_RATIOS=[.717],
                PRECISION='float32', SPECTROGRAM_ONLY=True,
                CONFIG='mels').items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(jax_mels._cached_model, 'cache', {}, raising=False)
        promonet_tpu.data.synthetic.create(
            'synthetic', speakers=1, utterances=3, seconds=0.8)
        theirs = promonet_tpu.evaluate.datasets(['synthetic'])
        _, params, _ = jax_mels._cached_model(None)
        checkpoints = root / 'checkpoints'
        save = port.utils.checkpoint.save
        save(checkpoints / 'pitch-00000001.pt', bridge.pitch_state_dict(
            jax.device_get(jax_pitch.PitchCNN.instance().params)), step=1)
        save(checkpoints / 'ppg-00000001.pt', bridge.ppg_state_dict(
            jax.device_get(jax_ppg._model()[1])), step=1)
        save(checkpoints / 'generator-00000001.pt',
             bridge.generator_state_dict(jax.device_get(params)), step=1)
    config = port.config.load(MELS_CONFIG).replace(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=assets / 'partitions',
        RESULTS_DIR=root / 'port' / 'results',
        EVAL_DIR=root / 'port' / 'eval', CHECKPOINTS_DIR=checkpoints,
        RUNS_DIR=root / 'runs', HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH,
        EVALUATION_RATIOS=[.717], PRECISION='float32')
    ours = port.evaluate.datasets(
        ['synthetic'], checkpoint=checkpoints / 'generator-00000001.pt',
        config=config, device='cpu')
    return root, theirs['synthetic'], ours['synthetic']


def test_mels_evaluation_matches_jax(evaluations):
    root, theirs, ours = evaluations
    # Every condition is reported; only 'reconstructed' has jobs
    assert set(ours['objective']) == set(theirs['objective']) == {
        'reconstructed', 'shifted-072', 'stretched-072', 'scaled-072',
        'balance-072', 'loudness-072'}
    for condition, values in theirs['objective'].items():
        mine = ours['objective'][condition]
        assert set(mine) == set(values)
        if condition != 'reconstructed':
            assert mine == values
            continue
        for name, value in values.items():
            if isinstance(value, dict):
                for key, number in value.items():
                    np.testing.assert_allclose(mine[name][key], number,
                                               rtol=1e-4)
            else:
                np.testing.assert_allclose(mine[name], value, rtol=1e-4)
    assert ours['objective']['reconstructed']['loudness']['loudness'] > 0
    assert {'generate', 'preprocess', 'transcribe'} <= set(ours['benchmark'])
    written = json.loads((
        root / 'port' / 'results' / 'mels' / 'synthetic' / 'results.json'
    ).read_text())
    assert written['objective'] == ours['objective']


def test_mels_artefacts_match_jax(evaluations):
    root, _, _ = evaluations
    theirs, ours = root / 'jax' / 'eval', root / 'port' / 'eval'
    files = sorted(path.relative_to(theirs) for path in theirs.rglob('*.*'))
    assert files == sorted(path.relative_to(ours) for path in ours.rglob('*.*'))
    assert {file.parts[1] for file in files} == {'original', 'reconstructed'}
    assert len(files) == 4 + 1 + 1
    tolerances = {
        'loudness': dict(rtol=0, atol=1e-2), 'pitch': dict(rtol=1e-4),
        'periodicity': dict(rtol=0, atol=5e-4),
        'ppg': dict(rtol=0, atol=1e-4)}
    for file in files:
        if file.suffix == '.npy':
            expected, value = np.load(theirs / file), np.load(ours / file)
            assert value.shape == expected.shape, file
            np.testing.assert_allclose(
                value, expected, err_msg=str(file),
                **tolerances[file.stem.rsplit('-', 1)[1]])
        else:
            expected, _ = port.utils.audio.load(theirs / file)
            value, _ = port.utils.audio.load(ours / file)
            assert value.shape == expected.shape, file
            np.testing.assert_allclose(
                value, expected, rtol=0, atol=2 / 32768, err_msg=str(file))
