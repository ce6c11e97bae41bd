"""The port's training losses held against the JAX package's.

Every loss on the same numpy-seeded float32 inputs, within 1e-6
relative: the adversarial losses (least squares and hinge), feature
matching (with and without its first maps), multi-resolution spectral
convergence, the normalized-correlation signal loss, and the mel loss
(plain, sparse, and masked). The masked mel loss must ignore what lies
in the padded columns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.train import loss as jax_loss

import promonet_tpu_torch as port
from promonet_tpu_torch.train import loss

RTOL = 1e-6


def _logits(rng, count=3):
    return [rng.standard_normal((2, 40 + 7 * i)).astype(np.float32)
            for i in range(count)]


def _maps(rng):
    return [[rng.standard_normal((2, 4, 9 + j)).astype(np.float32)
             for j in range(3)] for _ in range(2)]


def _torch(arrays):
    if isinstance(arrays, list):
        return [_torch(array) for array in arrays]
    return torch.from_numpy(arrays)


@pytest.mark.parametrize('hinge', [False, True])
def test_adversarial_losses_match_jax(hinge, monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'ADVERSARIAL_HINGE_LOSS', hinge)
    config = port.config.load().replace(ADVERSARIAL_HINGE_LOSS=hinge)
    rng = np.random.default_rng(0)
    real, fake = _logits(rng), _logits(rng)
    theirs = jax_loss.discriminator(real, fake)
    ours = loss.discriminator(_torch(real), _torch(fake), config)
    np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=RTOL)
    for kind in (1, 2):
        np.testing.assert_allclose(
            [float(x) for x in ours[kind]], [float(x) for x in theirs[kind]],
            rtol=RTOL)
    theirs = jax_loss.generator(fake)
    ours = loss.generator(_torch(fake), config)
    np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=RTOL)
    np.testing.assert_allclose(
        [float(x) for x in ours[1]], [float(x) for x in theirs[1]],
        rtol=RTOL)


@pytest.mark.parametrize('omit_first', [False, True])
def test_feature_matching_matches_jax(omit_first, monkeypatch):
    monkeypatch.setattr(
        promonet_tpu, 'FEATURE_MATCHING_OMIT_FIRST', omit_first)
    config = port.config.load().replace(
        FEATURE_MATCHING_OMIT_FIRST=omit_first)
    rng = np.random.default_rng(1)
    real, fake = _maps(rng), _maps(rng)
    np.testing.assert_allclose(
        float(loss.feature_matching(_torch(real), _torch(fake), config)),
        float(jax_loss.feature_matching(real, fake)), rtol=RTOL)


def test_feature_matching_does_not_train_the_real_side():
    rng = np.random.default_rng(2)
    real = [[torch.from_numpy(rng.standard_normal((2, 5)).astype(
        np.float32)).requires_grad_()]]
    fake = [[torch.from_numpy(rng.standard_normal((2, 5)).astype(
        np.float32)).requires_grad_()]]
    loss.feature_matching(real, fake, port.config.load()).backward()
    assert real[0][0].grad is None and fake[0][0].grad is not None


def test_spectral_convergence_matches_jax():
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((2, 1, 8192))).astype(np.float32)
    y = (0.3 * rng.standard_normal((2, 1, 8192))).astype(np.float32)
    np.testing.assert_allclose(
        float(loss.multi_resolution_spectral_convergence(
            _torch(x), _torch(y))),
        float(jax_loss.multi_resolution_spectral_convergence(x, y)),
        rtol=RTOL)


def test_signal_loss_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    y = (x + 0.5 * rng.standard_normal((3, 4096))).astype(np.float32)
    np.testing.assert_allclose(
        float(loss.signal(_torch(x), _torch(y))),
        float(jax_loss.signal(x, y)), rtol=RTOL)


def _mel_inputs(frames=16):
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal((2, 1, frames * 256))).astype(
        np.float32)
    spectrograms = np.abs(rng.standard_normal((2, 513, frames))).astype(
        np.float32) + 1e-3
    return spectrograms, audio


@pytest.mark.parametrize('sparse', [False, True])
def test_mel_loss_matches_jax(sparse, monkeypatch):
    overrides = dict(SPARSE_MEL_LOSS=sparse)
    if sparse:
        overrides['DYNAMIC_RANGE_COMPRESSION_THRESHOLD'] = 1e-5
    config = port.config.load().replace(**overrides)
    for name, value in overrides.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    monkeypatch.setattr(
        promonet_tpu, 'LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD',
        config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD)
    spectrograms, audio = _mel_inputs()
    np.testing.assert_allclose(
        float(loss.mel(_torch(spectrograms), _torch(audio), config)),
        float(jax_loss.mel(spectrograms, audio)), rtol=RTOL)


def test_masked_mel_loss_matches_jax_and_ignores_padding():
    config = port.config.load()
    spectrograms, audio = _mel_inputs()
    frames = 11
    mask = np.arange(16) < frames
    theirs = float(jax_loss.mel(spectrograms, audio, jnp.asarray(mask)[None]))
    ours = loss.mel(
        _torch(spectrograms), _torch(audio), config,
        torch.from_numpy(mask)[None])
    np.testing.assert_allclose(float(ours), theirs, rtol=RTOL)
    # Zero columns past the mask (bucket padding) change nothing and stay
    # finite
    padded = spectrograms.copy()
    padded[..., frames:] = 0.
    again = loss.mel(
        _torch(padded), _torch(audio), config, torch.from_numpy(mask)[None])
    assert np.isfinite(float(again))
    np.testing.assert_allclose(float(again), float(ours), rtol=RTOL)
    # and the unmasked loss sees them
    assert not np.isfinite(float(loss.mel(
        _torch(padded), _torch(audio), config)))


def test_mel_loss_is_zero_for_the_audio_itself():
    config = port.config.load()
    rng = np.random.default_rng(6)
    audio = torch.from_numpy(
        (0.3 * rng.standard_normal((1, 1, 4096))).astype(np.float32))
    spectrograms = port.preprocess.spectrogram.from_audio(audio, config)
    assert float(loss.mel(spectrograms, audio, config)) == 0.
