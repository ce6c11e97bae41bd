"""The WORLD baseline held against the JAX package's.

Both packages compute WORLD in float64 numpy on the host with the same
synthesis noise (`np.random.default_rng(0)`), so on the same input the
analysis, the stretch and the synthesis are equal exactly: 0.5 and 0.8 s
inputs (a vibrato with harmonics, and a tone in noise), with a pitch
shift, with a time stretch along the same grid, and unvoiced. Only the
loudness matching after synthesis runs in float32 (the A-weighted
loudness and the limiter): within 1e-5.

The evaluation under MODEL='world' (configs/baselines/world.py) is in
`test_torch_world_evaluate.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import promonet_tpu.baseline.world as jax_world

import promonet_tpu_torch as port

SAMPLE_RATE = 22050


def _audio(kind, seconds):
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    if kind == 'vibrato':
        pitch = 180. + 40. * np.sin(2 * np.pi * 3. * t)
        phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
        audio = sum((.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    else:
        rng = np.random.default_rng(3)
        audio = np.sin(2 * np.pi * 140. * t) + .1 * rng.standard_normal(
            len(t))
    return (.4 * audio / np.abs(audio).max()).astype(np.float32)[None]


CASES = [('vibrato', .5), ('noisy', .8)]


@pytest.mark.parametrize('kind,seconds', CASES)
def test_analyze_matches_jax(kind, seconds):
    audio = _audio(kind, seconds)
    theirs = jax_world.analyze(audio)
    ours = port.baseline.world.analyze(audio, config=port.config.load())
    assert ours[0].shape == (int(seconds * SAMPLE_RATE) // 256,)
    assert (ours[0] > 0).any()
    for mine, value in zip(ours, theirs):
        assert mine.dtype == value.dtype == np.float64
        np.testing.assert_array_equal(mine, value)


@pytest.mark.parametrize('kind,seconds', CASES)
def test_from_audio_matches_jax(kind, seconds):
    audio = _audio(kind, seconds)
    config = port.config.load()
    frames = audio.shape[-1] // 256
    f0 = jax_world.analyze(audio)[0]
    grid = np.asarray(jnp.linspace(
        0., frames - 1, int(round(frames / 1.414)), dtype=jnp.float32))
    periodicity = np.where(f0 > 0, .9, 0.).astype(np.float32)
    for kwargs in (
        {},
        {'pitch': (1.25 * f0).astype(np.float32)},
        {'pitch': (1.25 * f0).astype(np.float32), 'periodicity': periodicity},
        {'grid': grid},
        {'grid': grid, 'pitch': np.full(len(grid), 150., np.float32)},
    ):
        theirs = jax_world.from_audio(audio, **kwargs)
        ours = port.baseline.world.from_audio(audio, config=config, **kwargs)
        assert ours.dtype == theirs.dtype == np.float32
        assert ours.shape == theirs.shape == (
            1, len(kwargs.get('grid', f0)) * 256)
        np.testing.assert_array_equal(ours, theirs, err_msg=str(kwargs))


def test_unvoiced_and_stretch_match_jax():
    f0 = np.zeros(20)
    envelope = np.abs(np.random.default_rng(0).standard_normal((513, 20)))
    aperiodicity = np.full((513, 20), .5)
    grid = np.linspace(0., 19., 31)
    for ours, theirs in zip(
            port.baseline.world.linear_time_stretch(
                f0, envelope, aperiodicity, grid),
            jax_world.linear_time_stretch(f0, envelope, aperiodicity, grid)):
        np.testing.assert_array_equal(ours, theirs)
    f0 = np.where(np.arange(20) % 7 < 4, 120. + np.arange(20), 0.)
    for ours, theirs in zip(
            port.baseline.world.linear_time_stretch(
                f0, envelope, aperiodicity, grid),
            jax_world.linear_time_stretch(f0, envelope, aperiodicity, grid)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        port.baseline.world.synthesize(f0, envelope, aperiodicity),
        jax_world.synthesize(f0, envelope, aperiodicity))


def test_loudness_matching_matches_jax():
    audio = _audio('vibrato', .5)
    config = port.config.load()
    frames = audio.shape[-1] // 256
    target = np.linspace(-30., -10., frames, dtype=np.float32)[None]
    theirs = jax_world.from_audio(audio, loudness=target)
    ours = port.baseline.world.from_audio(
        audio, loudness=target, config=config)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    # Several bands are averaged first, as in the JAX package
    bands = target + np.linspace(-4., 4., 8, dtype=np.float32)[:, None]
    np.testing.assert_allclose(
        port.baseline.world.from_audio(audio, loudness=bands, config=config),
        jax_world.from_audio(audio, loudness=bands), rtol=0, atol=1e-5)
