"""The port's editing chain held against the JAX package's, end to end.

preprocess → edit → synthesize on a second of harmonic audio, with the
shipped pitch and PPG checkpoints on both sides (carried over by the
bridge) and a narrow float32 generator with shared random weights. The
JAX side runs its exact-length path: numpy features between stages.
Also: the port imports neither JAX nor the JAX package, and its entry
points refuse to run on a missing GPU rather than fall back.
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

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

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
    code = (
        'import sys, promonet_tpu_torch; '
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
