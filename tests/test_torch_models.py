"""Port's models, with weights carried over by the bridge, held against
the JAX package's Flax models in float32.

Every parameter leaf is perturbed with seeded noise before the bridge,
so biases, LayerNorm scales and weight-norm gains all differ from their
initial values and a mis-mapped leaf shows. Tolerance: float32 sum
order, 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.models import modules as jax_modules
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.models.modules import ConvTranspose1d, same_padding


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32) +
        scale * rng.standard_normal(np.shape(leaf)).astype(np.float32),
        jax.device_get(params))


def _assert_close(ours, theirs):
    ours = np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


@pytest.mark.parametrize('length,kernel,stride', [
    (1024, 32, 4), (256, 16, 2), (128, 8, 2), (64, 8, 1), (64, 4, 1),
    (100, 5, 1), (7, 4, 3)])
def test_same_padding_matches_flax(length, kernel, stride):
    pads = jax.lax.padtype_to_pads((length,), (kernel,), (stride,), 'SAME')
    assert same_padding(length, kernel, stride) == tuple(pads[0])


def test_pitch_cnn_matches_jax():
    module = jax_pitch.PitchCNN.Model()
    params = _perturbed(
        module.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024))), 1)
    frames = np.random.default_rng(2).standard_normal(
        (5, 1024)).astype(np.float32)
    theirs = module.apply(params, jnp.asarray(frames))
    model = port.preprocess.PitchCNN()
    model.load_state_dict(bridge.pitch_state_dict(params))
    with torch.no_grad():
        _assert_close(model(torch.from_numpy(frames)).numpy(), theirs)


def test_ppg_encoder_matches_jax():
    module = jax_ppg.PPGEncoder(num_phonemes=40)
    params = _perturbed(
        module.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))), 3)
    mels = np.random.default_rng(4).standard_normal(
        (2, 23, 80)).astype(np.float32)
    theirs = module.apply(params, jnp.asarray(mels))
    model = port.preprocess.PPGEncoder()
    model.load_state_dict(bridge.ppg_state_dict(params))
    with torch.no_grad():
        _assert_close(model(torch.from_numpy(mels)).numpy(), theirs)


@pytest.mark.parametrize('kernel_size,stride', [(16, 8), (4, 2)])
def test_transposed_conv_taps_are_flipped(kernel_size, stride):
    """torch ConvTranspose1d weight = JAX lhs-dilated kernel flipped on k"""
    padding = (kernel_size - stride) // 2
    module = jax_modules.WNConvTranspose1d(
        6, kernel_size, stride=stride, padding=padding, subpixel=False)
    x = np.random.default_rng(5).standard_normal((2, 9, 5)).astype(
        np.float32)
    params = _perturbed(module.init(jax.random.PRNGKey(1), jnp.asarray(x)), 6)
    theirs = np.asarray(module.apply(params, jnp.asarray(x)))
    leaves = params['params']
    kernel = bridge.weight_norm(
        leaves['kernel_v'], leaves['kernel_g'], (0, 2))
    ours = ConvTranspose1d(5, 6, kernel_size, stride, padding)
    with torch.no_grad():
        ours.bias.copy_(torch.from_numpy(leaves['bias']))
        ours.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel[::-1].transpose(1, 2, 0))))
        _assert_close(ours(torch.from_numpy(x)).numpy(), theirs)
        # Without the flip the taps land on the wrong output samples
        ours.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(1, 2, 0))))
        assert not np.allclose(
            ours(torch.from_numpy(x)).numpy(), theirs, atol=1e-3)


def _narrow_generators(monkeypatch, initial_size=32):
    monkeypatch.setattr(
        promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', initial_size)
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=initial_size, PRECISION='float32')
    return jax_model, port.models.Generator(config)


def _generator_inputs(seed, batch, frames):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((batch, 40, frames)) * 2
    return (
        rng.uniform(-100, 20, (batch, 513, frames)).astype(np.float32),
        rng.uniform(40, 600, (batch, frames)).astype(np.float32),
        rng.uniform(0, 1, (batch, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
            np.float32),
        np.array([3, 1][:batch], np.int32),
        np.array([1., 0.8][:batch], np.float32),
        np.array([1., 1.2][:batch], np.float32))


def test_narrow_generator_matches_jax(monkeypatch):
    jax_model, model = _narrow_generators(monkeypatch)
    inputs = _generator_inputs(7, 2, 20)
    params = _perturbed(jax.jit(jax_model.init)(
        jax.random.PRNGKey(2), *map(jnp.asarray, inputs)), 8)
    theirs = jax.jit(jax_model.apply)(params, *map(jnp.asarray, inputs))
    model.load_state_dict(bridge.generator_state_dict(params))
    with torch.no_grad():
        ours = model(*(torch.from_numpy(np.asarray(x)).long()
                       if x.dtype == np.int32 else torch.from_numpy(x)
                       for x in inputs))
    assert ours.shape == (2, 1, 20 * 256)
    _assert_close(ours.numpy(), theirs)


def test_generator_feature_preparation_matches_jax(monkeypatch):
    jax_model, model = _narrow_generators(monkeypatch)
    inputs = _generator_inputs(9, 2, 31)
    params = _perturbed(jax.jit(jax_model.init)(
        jax.random.PRNGKey(3), *map(jnp.asarray, inputs)), 10)
    theirs = jax_model.apply(
        params, *map(jnp.asarray, inputs[:4]),
        method=jax_model.prepare_features)
    model.load_state_dict(bridge.generator_state_dict(params))
    with torch.no_grad():
        ours = model.prepare_features(*map(torch.from_numpy, inputs[:4]))
    _assert_close(ours.numpy(), theirs)


def test_bridge_rejects_missing_and_leftover_leaves(monkeypatch):
    module = jax_pitch.PitchCNN.Model()
    params = jax.device_get(
        module.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024))))['params']
    extra = dict(params, Extra_0={'kernel': np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match='Extra_0'):
        bridge.pitch_state_dict(extra)
    missing = {k: v for k, v in params.items() if k != 'LayerNorm_3'}
    with pytest.raises(KeyError, match='LayerNorm_3'):
        bridge.pitch_state_dict(missing)
