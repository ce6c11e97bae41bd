"""Port's residual block held against the JAX package's plain chain and
its Pallas kernel (interpret mode).

float32 first, with a tight bound (the chains round alike and differ
only in float32 sum order). Then bfloat16 per element: a different sum
order flips a rounding now and then, and a flipped rounding propagates
through the remaining convolutions, so the bound is
|ours - theirs| <= 2^-5 * (|theirs| + 2 * rms(theirs)): four bf16 ulps
relative to the element, with a floor at twice the output's RMS because
where the residual add cancels the error stays at the operands' scale.
It is the bound of tests/test_torch_cuda.py and chip_smoke.py, and tight
enough that zeroing a single bias breaks it, which a test checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promonet_tpu.ops import resblock as jax_resblock
from promonet_tpu_torch.ops import resblock

DILATIONS = (1, 3, 5)
BF16_RTOL = 2. ** -5


def _block(seed, batch, frames, channels, kernel_size):
    rng = np.random.default_rng(seed)
    weights = (rng.standard_normal((6, kernel_size, channels, channels)) /
               np.sqrt(kernel_size * channels)).astype(np.float32)
    biases = (0.1 * rng.standard_normal((6, channels))).astype(np.float32)
    x = rng.standard_normal((batch, frames, channels)).astype(np.float32)
    return x, weights, biases


def _jax(x, weights, biases, dtype):
    return np.asarray(jax_resblock.reference_block(
        jnp.asarray(x).astype(dtype), jnp.asarray(weights).astype(dtype),
        jnp.asarray(biases), DILATIONS, 0.1, dtype), np.float32)


def _ours(x, weights, biases, dtype):
    return resblock.fused_block(
        torch.from_numpy(x).to(dtype), torch.from_numpy(weights).to(dtype),
        torch.from_numpy(biases), DILATIONS, 0.1).float().numpy()


def _within_bf16_bound(ours, theirs):
    floor = 2 * np.sqrt(np.mean(np.square(theirs)))
    return np.all(
        np.abs(ours - theirs) <= BF16_RTOL * (np.abs(theirs) + floor))


@pytest.mark.parametrize('channels,kernel_size', [(8, 3), (16, 7), (32, 11)])
@pytest.mark.parametrize('batch', [1, 4])
def test_float32_matches_jax_reference(batch, channels, kernel_size):
    problem = _block(channels + batch, batch, 97, channels, kernel_size)
    np.testing.assert_allclose(
        _ours(*problem, torch.float32), _jax(*problem, jnp.float32),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('channels,kernel_size', [
    (32, 3), (64, 7), (128, 11)])
@pytest.mark.parametrize('batch', [1, 4])
def test_bfloat16_matches_jax_reference_per_element(
    batch, channels, kernel_size
):
    problem = _block(kernel_size + batch, batch, 150, channels, kernel_size)
    ours = _ours(*problem, torch.bfloat16)
    theirs = _jax(*problem, jnp.bfloat16)
    assert ours.shape == theirs.shape == (batch, 150, channels)
    assert _within_bf16_bound(ours, theirs)


@pytest.mark.parametrize('kernel_size', [3, 11])
def test_bfloat16_matches_pallas_kernel(kernel_size):
    """Multi-tile interpret-mode kernel with a ragged final tile"""
    x, weights, biases = _block(kernel_size, 2, 300, 64, kernel_size)
    theirs = np.asarray(jax_resblock._pallas_forward(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(weights).astype(jnp.bfloat16),
        jnp.asarray(biases), DILATIONS, 0.1, interpret=True, tile=128),
        np.float32)
    assert _within_bf16_bound(_ours(x, weights, biases, torch.bfloat16),
                              theirs)


def test_bfloat16_bound_catches_a_zeroed_bias():
    x, weights, biases = _block(0, 1, 150, 64, 7)
    theirs = _jax(x, weights, biases, jnp.bfloat16)
    channel = np.argmax(np.abs(biases[5]))
    broken = biases.copy()
    broken[5, channel] = 0.
    assert not _within_bf16_bound(
        _ours(x, weights, broken, torch.bfloat16), theirs)


def test_leaky_relu_rounds_slope_like_jax():
    x = torch.linspace(-4, 4, 1001).to(torch.bfloat16)
    theirs = np.asarray(
        jax_resblock._leaky(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16), 0.1), np.float32)
    np.testing.assert_array_equal(
        resblock.leaky_relu(x, 0.1).float().numpy(), theirs)


def test_cpu_path_counts_no_launch():
    before = resblock.fused_block.launches
    _ours(*_block(1, 1, 20, 8, 3), torch.float32)
    assert resblock.fused_block.launches == before
