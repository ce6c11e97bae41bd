"""The port's editing chain held against the JAX package's, end to end.

preprocess → edit → synthesize on a second of harmonic audio, with the
shipped pitch and PPG checkpoints on both sides (carried over by the
bridge) and a narrow float32 generator with shared random weights. The
JAX side runs its exact-length path: numpy features between stages.
Also: the 'dsp' pitch front end and both decoders, the PPG-aware
stretch, and `from_edited_audio` (one call, bucket-shaped on the device)
against the JAX package's fused program; the port imports neither JAX
nor the JAX package, and its entry points refuse to run on a missing GPU
rather than fall back.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.synthesize.core as jax_synthesize_core
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu.edit.core as jax_edit_core

import promonet_tpu_torch as port
from promonet_tpu_torch.edit.core import _selective_grid
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.preprocess import pitch as pitch_module

EDIT = dict(
    pitch_shift_cents=400., time_stretch_ratio=1 / 1.4, loudness_scale_db=3.)


def _harmonic_audio(seconds=1.):
    sr = promonet_tpu.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / sr
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    audio += 0.01 * np.random.default_rng(0).standard_normal(t.shape)
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


@pytest.fixture(scope='module')
def front_ends():
    """Port pitch CNN and PPG encoder with the JAX package's weights"""
    pitch_model = port.preprocess.PitchCNN()
    pitch_model.load_state_dict(bridge.pitch_state_dict(
        jax.device_get(jax_pitch.PitchCNN.instance().params)))
    ppg_model = port.preprocess.PPGEncoder()
    ppg_model.load_state_dict(bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])))
    return pitch_model, ppg_model


@pytest.fixture(scope='module')
def features(front_ends):
    audio = _harmonic_audio()
    theirs = [
        np.asarray(x) for x in
        promonet_tpu.preprocess.from_audio(audio, loudness_bands=None)]
    ours = port.preprocess.from_audio(
        audio, *front_ends, loudness_bands=None, device='cpu')
    return theirs, ours


def test_preprocess_matches_jax(features):
    theirs, ours = features
    names = ('loudness', 'pitch', 'periodicity', 'ppg')
    frames = _harmonic_audio().shape[-1] // 256
    for name, a, b in zip(names, ours, theirs):
        assert a.dtype == torch.float32, name
        assert tuple(a.shape) == b.shape, name
        assert b.shape[-1] == frames, name
    loudness, pitch, periodicity, ppg = (x.numpy() for x in ours)
    # dB of float32 FFT magnitudes: quiet bins move by up to ~1e-2 dB
    np.testing.assert_allclose(loudness, theirs[0], rtol=0, atol=1e-2)
    # Same Viterbi path; sub-bin refinement in float32
    np.testing.assert_allclose(pitch, theirs[1], rtol=1e-4)
    np.testing.assert_allclose(periodicity, theirs[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ppg, theirs[3], rtol=0, atol=1e-4)


def test_edit_matches_jax(features):
    theirs, ours = features
    theirs = [np.asarray(x) for x in promonet_tpu.edit.from_features(
        *theirs, **EDIT)]
    ours = port.edit.from_features(*ours, **EDIT)
    assert theirs[1].shape[-1] == round(86 * 1.4)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
    np.testing.assert_allclose(ours[0].numpy(), theirs[0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(ours[1].numpy(), theirs[1], rtol=1e-4)
    np.testing.assert_allclose(ours[2].numpy(), theirs[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[3].numpy(), theirs[3], rtol=0, atol=1e-4)


def test_edit_chain_matches_jax(features, monkeypatch):
    """The whole slice: features → edit → narrow float32 generator"""
    monkeypatch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', 32)
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    theirs, ours = features
    theirs = [np.asarray(x) for x in promonet_tpu.edit.from_features(
        *theirs, **EDIT)]
    frames = theirs[1].shape[-1]
    bucket = port.data.bucket_frames(
        frames, promonet_tpu.INFERENCE_FRAME_BUCKETS)
    params = jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 513, bucket)), jnp.full((1, bucket), 100.),
        jnp.zeros((1, bucket)), jnp.full((1, 40, bucket), 1 / 40),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), jnp.ones((1,))))
    monkeypatch.setattr(
        jax_synthesize_core, '_cached_model',
        lambda checkpoint: (jax_model, params, jax.jit(jax_model.apply)))
    expected = promonet_tpu.synthesize.from_features(*theirs, speaker=3)

    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, PRECISION='float32')
    generator = port.models.Generator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    edited = port.edit.from_features(*ours, **EDIT)
    audio = port.synthesize.from_features(
        *edited, generator=generator, speaker=3, device='cpu')
    assert audio.shape == expected.shape == (1, frames * 256)
    assert np.isfinite(audio).all()
    np.testing.assert_allclose(
        audio, expected, rtol=0, atol=1e-3 * np.abs(expected).max())

    pcm = port.synthesize.from_features(
        *edited, generator=generator, speaker=3, output_dtype='int16',
        device='cpu')
    assert pcm.dtype == np.int16
    np.testing.assert_array_equal(
        pcm, np.clip(np.round(audio * 32767.), -32768, 32767))


###############################################################################
# The 'dsp' pitch front end, argmax decoding, unvoiced interpolation
###############################################################################


def _voiced_then_noise():
    """Half a second of harmonics, then noise: frames of both kinds"""
    audio = _harmonic_audio(1.)
    rng = np.random.default_rng(1)
    audio[0, 11025:] = 0.05 * rng.standard_normal(11025)
    return audio


def test_dsp_posteriorgram_matches_jax():
    audio = _voiced_then_noise()
    theirs = np.asarray(jax_pitch.posteriorgram(jnp.asarray(audio), 22050, 256))
    ours = pitch_module.posteriorgram(
        torch.from_numpy(audio), 22050, 256, promonet_tpu.FMIN,
        promonet_tpu.FMAX).numpy()
    assert ours.shape == theirs.shape == (86, 256)
    # Correlations in [-1, 1]: float32 FFTs and running sums of squares
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    assert ours.max() > 0.9


@pytest.mark.parametrize('interp_at', [None, promonet_tpu.VOICING_THRESHOLD])
@pytest.mark.parametrize('decoder', ['viterbi', 'argmax'])
@pytest.mark.parametrize('kind', ['dsp', 'cnn'])
def test_pitch_decode_matches_jax(kind, decoder, interp_at, front_ends):
    """The same scores through both decoders: equal bins

    Periodicity is read off the scores at the decoded bin ('dsp') or is
    the posterior there ('cnn'), so equal periodicity means equal bins.
    """
    audio = _voiced_then_noise()
    if kind == 'dsp':
        scores = np.asarray(jax_pitch.posteriorgram(
            jnp.asarray(audio), 22050, 256))
    else:
        scores = np.asarray(jax_pitch.cnn_posteriorgram(
            jax_pitch.PitchCNN.instance().params, jnp.asarray(audio), 22050,
            256))
    pitch, periodicity = jax_pitch._decode(jnp.asarray(scores), decoder, kind)
    ours_pitch, ours_periodicity = pitch_module.decode(
        torch.from_numpy(scores), promonet_tpu.FMIN, promonet_tpu.FMAX,
        decoder, kind)
    if kind == 'dsp':
        np.testing.assert_array_equal(
            ours_periodicity.numpy(), np.asarray(periodicity))
    else:
        np.testing.assert_allclose(
            ours_periodicity.numpy(), np.asarray(periodicity), rtol=0,
            atol=1e-5)
    np.testing.assert_allclose(
        ours_pitch.numpy(), np.asarray(pitch), rtol=1e-3)

    # The whole estimator on the audio, with the interpolation
    config = port.config.load().replace(PITCH_ESTIMATOR=kind)
    theirs = jax_pitch._from_audio_jit(
        jnp.asarray(audio),
        jax_pitch.PitchCNN.instance().params if kind == 'cnn' else {},
        22050, 256, decoder, interp_at, kind)
    with torch.no_grad():
        ours = pitch_module.estimate(
            torch.from_numpy(audio), front_ends[0], config, decoder,
            interp_at)
    assert tuple(ours[0].shape) == tuple(ours[1].shape) == (1, 86)
    np.testing.assert_allclose(
        ours[0].numpy(), np.asarray(theirs[0]), rtol=1e-3)
    np.testing.assert_allclose(
        ours[1].numpy(), np.asarray(theirs[1]), rtol=0, atol=1e-4)
    if interp_at is not None:
        unvoiced = np.asarray(theirs[1])[0] <= interp_at
        assert unvoiced.any() and not unvoiced.all()


@pytest.mark.parametrize('estimator', ['dsp', 'cnn'])
def test_pitch_from_audio_follows_the_threshold_rules(
    estimator, front_ends, monkeypatch
):
    """Default threshold: the config's, or the CNN's calibrated one"""
    monkeypatch.setattr(promonet_tpu, 'PITCH_ESTIMATOR', estimator)
    audio = _voiced_then_noise()
    theirs = jax_pitch.from_audio(audio)
    model = front_ends[0]
    monkeypatch.setattr(
        model, 'voicing_threshold',
        jax_pitch.PitchCNN.instance().voicing_threshold)
    config = port.config.load().replace(PITCH_ESTIMATOR=estimator)
    ours = pitch_module.from_audio(
        audio, model if estimator == 'cnn' else None, config=config,
        device='cpu')
    np.testing.assert_allclose(
        ours[0].numpy(), np.asarray(theirs[0]), rtol=1e-3)
    np.testing.assert_allclose(
        ours[1].numpy(), np.asarray(theirs[1]), rtol=0, atol=1e-4)
    kept = pitch_module.from_audio(
        audio, model, interp_unvoiced_at=None, decoder='argmax',
        config=config, device='cpu')
    assert not np.allclose(kept[0].numpy(), ours[0].numpy(), rtol=1e-3)
    with pytest.raises(ValueError, match='decoder'):
        pitch_module.from_audio(
            audio, model, decoder='beam', config=config, device='cpu')


@pytest.mark.parametrize('viterbi_decode', [True, False])
def test_preprocess_with_the_dsp_estimator_matches_jax(
    viterbi_decode, front_ends, monkeypatch
):
    monkeypatch.setattr(promonet_tpu, 'PITCH_ESTIMATOR', 'dsp')
    monkeypatch.setattr(promonet_tpu, 'VITERBI_DECODE_PITCH', viterbi_decode)
    audio = _voiced_then_noise()
    theirs = [np.asarray(x) for x in promonet_tpu.preprocess.from_audio(
        audio, features=('pitch', 'periodicity'))]
    config = port.config.load().replace(
        PITCH_ESTIMATOR='dsp', VITERBI_DECODE_PITCH=viterbi_decode)
    ours = port.preprocess.from_audio(
        audio, None, None, features=('pitch', 'periodicity'), config=config,
        device='cpu')
    np.testing.assert_allclose(ours[0].numpy(), theirs[0], rtol=1e-3)
    np.testing.assert_allclose(ours[1].numpy(), theirs[1], rtol=0, atol=1e-4)


def test_preprocess_resamples_another_sample_rate(front_ends):
    audio = _harmonic_audio(0.5)
    doubled = promonet_tpu.utils.audio.resample(audio, 22050, 44100)
    theirs = [np.asarray(x) for x in promonet_tpu.preprocess.from_audio(
        doubled, sample_rate=44100, features=('loudness', 'ppg'))]
    ours = port.preprocess.from_audio(
        doubled, *front_ends, sample_rate=44100, features=('loudness', 'ppg'),
        device='cpu')
    assert tuple(ours[0].shape) == theirs[0].shape == (8, 43)
    np.testing.assert_allclose(ours[0].numpy(), theirs[0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(ours[1].numpy(), theirs[1], rtol=0, atol=1e-4)


###############################################################################
# The PPG-aware stretch
###############################################################################


def _phoneme_ppg(frames=90, seed=2):
    """A PPG that dwells on one phoneme at a time, silence at both ends"""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, frames))
    phonemes = np.repeat(rng.integers(0, 39, frames // 10 + 1), 10)[:frames]
    phonemes[:8] = phonemes[-8:] = 39
    logits[phonemes, np.arange(frames)] += 6.
    ppg = np.exp(logits) / np.exp(logits).sum(axis=0)
    return ppg.astype(np.float32)


@pytest.mark.parametrize('ratio', [1 / 1.4, 1.3])
@pytest.mark.parametrize('stretch_unvoiced,stretch_silence', [
    (True, True), (True, False), (False, True), (False, False)])
def test_selective_grid_matches_jax(stretch_unvoiced, stretch_silence, ratio):
    ppg = _phoneme_ppg()
    theirs = np.asarray(jax_edit_core._selective_grid(
        ppg, ratio, stretch_unvoiced, stretch_silence))
    ours = _selective_grid(ppg, ratio, stretch_unvoiced, stretch_silence)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    assert len(ours) == round(90 / ratio)
    # The same host arithmetic; only the order in which the selected
    # phonemes' rows are summed may differ
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('stretch_unvoiced,stretch_silence', [
    (True, False), (False, True), (False, False)])
def test_selective_edit_matches_jax(stretch_unvoiced, stretch_silence):
    rng = np.random.default_rng(3)
    ppg = _phoneme_ppg()
    loudness = rng.standard_normal((8, 90)).astype(np.float32)
    pitch = (150 + 50 * rng.random((1, 90))).astype(np.float32)
    periodicity = rng.random((1, 90)).astype(np.float32)
    kwargs = dict(
        EDIT, stretch_unvoiced=stretch_unvoiced,
        stretch_silence=stretch_silence, return_grid=True)
    theirs = [np.asarray(x) for x in promonet_tpu.edit.from_features(
        loudness, pitch, periodicity, ppg, **kwargs)]
    ours = port.edit.from_features(
        *map(torch.from_numpy, (loudness, pitch, periodicity, ppg)), **kwargs)
    assert len(ours) == 5 and ours[4].shape == (126,)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
    # Exempt frames keep their rate: the grid is not the constant one
    constant = port.edit.from_features(
        *map(torch.from_numpy, (loudness, pitch, periodicity, ppg)),
        **dict(EDIT, return_grid=True))[4]
    assert not np.allclose(ours[4].numpy(), constant.numpy(), atol=0.5)


###############################################################################
# Audio in, edited audio out
###############################################################################


@pytest.fixture
def narrow_generators(monkeypatch):
    """A narrow float32 generator on both sides, with the same weights

    The JAX package finds its model under the checkpoint key 'narrow'.
    """
    monkeypatch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', 32)
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 513, 64)), jnp.full((1, 64), 100.),
        jnp.zeros((1, 64)), jnp.full((1, 40, 64), 1 / 40),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), jnp.ones((1,))))
    monkeypatch.setattr(
        jax_synthesize_core._cached_model, 'cache',
        {'narrow': (jax_model, params, jax.jit(jax_model.apply))},
        raising=False)
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, PRECISION='float32')
    generator = port.models.Generator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    return generator


@pytest.mark.parametrize('case', ['float32', 'int16', '44100', 'no-stretch'])
def test_from_edited_audio_matches_jax(case, front_ends, narrow_generators):
    """One call on bucket-shaped tensors against the JAX fused program

    Tolerance of the three-call chain above: 1e-3 of the peak.
    """
    audio, kwargs = _harmonic_audio(0.5), dict(EDIT, speaker=3)
    if case == 'int16':
        audio = np.round(audio * 32767.).astype(np.int16)
    if case == '44100':
        audio = promonet_tpu.utils.audio.resample(audio, 22050, 44100)
        kwargs['sample_rate'] = 44100
    if case == 'no-stretch':
        kwargs = dict(pitch_shift_cents=-300., speaker=3)
    expected = promonet_tpu.synthesize.from_edited_audio(
        audio, checkpoint='narrow', **kwargs)
    ours = port.synthesize.from_edited_audio(
        audio, *front_ends, narrow_generators, device='cpu', **kwargs)
    frames = 43 if case == 'no-stretch' else round(43 * 1.4)
    assert ours.shape == expected.shape == (1, frames * 256)
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    np.testing.assert_allclose(
        ours, expected, rtol=0, atol=1e-3 * np.abs(expected).max())

    if case == 'int16':
        expected = promonet_tpu.synthesize.from_edited_audio(
            audio, checkpoint='narrow', output_dtype='int16', **kwargs)
        pcm = port.synthesize.from_edited_audio(
            audio, *front_ends, narrow_generators, output_dtype='int16',
            device='cpu', **kwargs)
        assert pcm.dtype == expected.dtype == np.int16
        np.testing.assert_array_equal(
            pcm, np.clip(np.round(ours * 32767.), -32768, 32767))
        assert np.abs(pcm.astype(int) - expected.astype(int)).max() <= \
            1 + 1e-3 * np.abs(expected).max()


@pytest.mark.parametrize('estimator', ['cnn', 'dsp'])
def test_from_edited_audio_selective_branch_matches_jax(
    estimator, front_ends, narrow_generators, monkeypatch
):
    monkeypatch.setattr(promonet_tpu, 'PITCH_ESTIMATOR', estimator)
    generator = narrow_generators
    generator.config = generator.config.replace(PITCH_ESTIMATOR=estimator)
    audio = _harmonic_audio(0.5)
    kwargs = dict(EDIT, speaker=3, stretch_unvoiced=False)
    expected = promonet_tpu.synthesize.from_edited_audio(
        audio, checkpoint='narrow', **kwargs)
    ours = port.synthesize.from_edited_audio(
        audio, *front_ends, generator, device='cpu', **kwargs)
    assert ours.shape == expected.shape == (1, round(43 * 1.4) * 256)
    np.testing.assert_allclose(
        ours, expected, rtol=0, atol=1e-3 * np.abs(expected).max())
    constant = port.synthesize.from_edited_audio(
        audio, *front_ends, generator, device='cpu', **dict(EDIT, speaker=3))
    assert not np.allclose(
        ours, constant, rtol=0, atol=1e-3 * np.abs(expected).max())
    # PCM in and out on this branch too (the JAX package passes the raw
    # integers on here and returns float32)
    pcm = np.round(audio * 32767.).astype(np.int16)
    from_pcm = port.synthesize.from_edited_audio(
        pcm, *front_ends, generator, output_dtype='int16', device='cpu',
        **kwargs)
    from_float = port.synthesize.from_edited_audio(
        pcm / np.float32(32768.), *front_ends, generator, device='cpu',
        **kwargs)
    assert from_pcm.dtype == np.int16
    np.testing.assert_array_equal(
        from_pcm, np.clip(np.round(from_float * 32767.), -32768, 32767))


def test_synthesis_replaces_nan_pitch_and_trims(features):
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=16, PRECISION='float32')
    generator = port.models.init.seeded(port.models.Generator(config), 0)
    _, ours = features
    loudness, pitch, periodicity, ppg = (x[..., :50] for x in ours)
    pitch = pitch.clone()
    pitch[0, 10:20] = float('nan')
    audio = port.synthesize.from_features(
        loudness, pitch, periodicity, ppg, generator=generator,
        device='cpu')
    filled = pitch.clone()
    filled[0, 10:20] = 100.
    again = port.synthesize.from_features(
        loudness, filled, periodicity, ppg, generator=generator,
        device='cpu')
    assert audio.shape == (1, 50 * 256)
    np.testing.assert_array_equal(audio, again)


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter"""
    code = (
        'import importlib, pkgutil, sys, promonet_tpu_torch; '
        'names = [m.name for m in pkgutil.walk_packages('
        'promonet_tpu_torch.__path__, "promonet_tpu_torch.")]; '
        '[importlib.import_module(name) for name in names]; '
        'assert "promonet_tpu_torch.synthesize.stream" in names; '
        'assert "promonet_tpu_torch.models.fargan" in names; '
        'assert {"promonet_tpu_torch." + name for name in ('
        '"preprocess.__main__", "edit.__main__", "synthesize.__main__", '
        '"preprocess.speaker", "utils.checkpoint", "utils.cli")} <= '
        'set(names); '
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "orbax", "promonet_tpu")]; '
        'print(bad); sys.exit(1 if bad else 0)')
    result = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_default_device_refuses_a_missing_gpu(features, front_ends):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the refusal is for hosts without one')
    _, ours = features
    with pytest.raises(RuntimeError, match='CUDA'):
        port.preprocess.from_audio(_harmonic_audio(0.1), *front_ends)
    generator = port.models.Generator(port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=16))
    with pytest.raises(RuntimeError, match='CUDA'):
        port.synthesize.from_features(*ours, generator=generator)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.synthesize.from_edited_audio(
            _harmonic_audio(0.1), *front_ends, generator)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.preprocess.harmonics.from_audio(_harmonic_audio(0.1))
    for analysis in (
        port.preprocess.harmonics.stft_features,
        port.preprocess.harmonics.lpc_coefficients,
        port.preprocess.harmonics.pitch_posteriorgram,
    ):
        with pytest.raises(RuntimeError, match='CUDA'):
            analysis(_harmonic_audio(0.1))
