"""CARGAN held against the JAX package's module.

The JAX `CARGAN` (Flax, float32, random weights from its init) and the
port's `models.cargan.CARGAN` with the same weights carried over by
`bridge.cargan_state_dict`, at a narrow width (HiFi-GAN 32 channels) on
numpy-seeded features, global features and previous samples: the audio
within 1e-5 (float32 on both sides; the CPU route of the port's Blocks is
the plain chain). Also: the generator refuses MODEL='cargan' with the JAX
generator's ValueError, and the encoder alone matches.
"""
import jax
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.models import cargan as jax_cargan

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge, cargan

WIDTH = 32


@pytest.fixture(scope='module')
def modules():
    """The JAX module and its parameters, and the port's with the same
    weights"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', WIDTH)
        rng = np.random.default_rng(0)
        features, global_features, previous = _inputs(rng)
        model = jax_cargan.CARGAN()
        params = jax.device_get(model.init(
            jax.random.PRNGKey(0), features, global_features, previous))
        theirs = np.asarray(jax.jit(model.apply)(
            params, features, global_features, previous))
        silent = np.asarray(jax.jit(model.apply)(
            params, features, global_features))
    config = port.config.load().replace(HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH)
    ours = cargan.CARGAN(features.shape[-1], global_features.shape[-1], config)
    ours.load_state_dict(bridge.cargan_state_dict(params))
    return params, ours.eval(), (features, global_features, previous), (
        theirs, silent)


def _inputs(rng, batch=2, frames=6, channels=20, global_channels=9):
    return (
        rng.standard_normal((batch, frames, channels)).astype(np.float32),
        rng.standard_normal((batch, 1, global_channels)).astype(np.float32),
        (0.3 * rng.standard_normal((batch, 1, 512))).astype(np.float32))


def test_cargan_matches_jax(modules):
    _, ours, inputs, (theirs, silent) = modules
    features, global_features, previous = map(torch.from_numpy, inputs)
    with torch.no_grad():
        audio = ours(features, global_features, previous)
        quiet = ours(features, global_features)
    assert audio.shape == theirs.shape == (2, 6 * 256, 1)
    assert audio.dtype == torch.float32
    np.testing.assert_allclose(audio.numpy(), theirs, atol=1e-5, rtol=0)
    # Without previous samples both start from silence
    np.testing.assert_allclose(quiet.numpy(), silent, atol=1e-5, rtol=0)
    assert not np.allclose(theirs, silent)


def test_encoder_matches_jax(modules):
    params, ours, (_, _, previous), _ = modules
    encoder = jax_cargan.Autoregressive()
    theirs = np.asarray(encoder.apply(
        {'params': params['params']['Autoregressive_0']}, previous))
    with torch.no_grad():
        encoded = ours.autoregressive(torch.from_numpy(previous))
    assert encoded.shape == (2, 128)
    np.testing.assert_allclose(encoded.numpy(), theirs, atol=1e-6, rtol=1e-6)


def test_bridge_uses_every_cargan_leaf(modules):
    params, ours, _, _ = modules
    state = bridge.cargan_state_dict(params)
    assert set(state) == set(ours.state_dict())
    # Weight norm is materialised: each g folds into its weight
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum(
        np.size(leaf) for path, leaf in flat
        if getattr(path[-1], 'key', None) != 'kernel_g') == sum(
            value.numel() for value in state.values())
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra['params']['Extra_0'] = {'kernel': np.zeros(2)}
    with pytest.raises(ValueError, match='Extra_0'):
        bridge.cargan_state_dict(extra)


def test_cargan_is_not_a_generator_model(monkeypatch):
    """Neither package's Generator builds it: the same ValueError"""
    config = port.config.load().replace(MODEL='cargan')
    with pytest.raises(ValueError, match='Generator model cargan is not'):
        port.models.Generator(config)
    monkeypatch.setattr(promonet_tpu, 'MODEL', 'cargan')
    with pytest.raises(ValueError, match='Generator model cargan is not'):
        model = promonet_tpu.models.Generator.create()
        model.init(jax.random.PRNGKey(0), *[
            np.zeros(shape, dtype) for shape, dtype in (
                ((1, 513, 2), np.float32), ((1, 2), np.float32),
                ((1, 2), np.float32), ((1, 40, 2), np.float32),
                ((1,), np.int32), ((1,), np.float32), ((1,), np.float32))])
    assert config.CARGAN_HIDDEN_SIZE == promonet_tpu.CARGAN_HIDDEN_SIZE
    assert config.CARGAN_OUTPUT_SIZE == promonet_tpu.CARGAN_OUTPUT_SIZE
    assert config.NUM_PREVIOUS_SAMPLES == config.CARGAN_INPUT_SIZE


def test_bfloat16_cargan_stays_near_float32(modules):
    """The compute dtype reaches the encoder and the HiFi-GAN: in bf16 on
    the CPU (the plain chain) within 5% relative RMS of float32"""
    _, ours, inputs, _ = modules
    features, global_features, previous = map(torch.from_numpy, inputs)
    with torch.no_grad():
        full = ours(features, global_features, previous)
        half = ours(features, global_features, previous, torch.bfloat16)
    assert half.dtype == torch.float32
    error = (half - full).pow(2).mean().sqrt() / full.pow(2).mean().sqrt()
    assert float(error) < 0.05
