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


###############################################################################
# What surrounds the CUDA kernel: weight packing, tile plan, Block's cache
###############################################################################


@pytest.mark.parametrize('channels,kernel_size', [
    (32, 3), (64, 7), (128, 11), (256, 3), (48, 7), (200, 3), (5, 1)])
def test_weight_packing_round_trips(channels, kernel_size):
    rng = np.random.default_rng(channels)
    weights = torch.from_numpy(rng.standard_normal(
        (6, kernel_size, channels, channels))).float()
    biases = torch.from_numpy(rng.standard_normal((6, channels))).float()
    packed = resblock.pack_weights(weights, biases)
    padded = resblock.padded_channels(channels)
    block_n, block_k = resblock.tile_shape(padded)
    assert packed.tensor.dtype == torch.bfloat16
    assert packed.tensor.is_contiguous()
    assert tuple(packed.tensor.shape) == (
        6, padded // block_n, padded // block_k, kernel_size, block_n,
        block_k)
    assert padded % block_n == 0 and padded % block_k == 0
    unpacked, unpacked_biases = resblock.unpack_weights(packed)
    assert torch.equal(unpacked, weights.to(torch.bfloat16))
    assert torch.equal(unpacked_biases, biases.to(torch.bfloat16))
    # Padded channels carry zeros: as many non-zeros as the kernels have
    assert int((packed.tensor != 0).sum()) == int(
        (weights.to(torch.bfloat16) != 0).sum())


@pytest.mark.parametrize('channels', [32, 128])
def test_packed_tile_is_the_swizzled_image_the_kernel_reads(channels):
    """Element (out n, in c) of a tile lies at byte n * row + 2 c with its
    16-byte chunk XORed by the row's 128-byte line (mod chunks per row)"""
    rng = np.random.default_rng(1)
    weights = torch.from_numpy(rng.standard_normal(
        (2, 3, channels, channels))).float()
    packed = resblock.pack_weights(weights, torch.zeros(2, channels))
    block_n, block_k = resblock.tile_shape(channels)
    row_bytes = 2 * block_k
    for conv, n_tile, piece, tap in ((0, 0, 0, 0), (1, 0, -1, 2)):
        tile = packed.tensor[conv, n_tile, piece, tap].reshape(-1)
        first = (packed.tensor.shape[2] + piece) % packed.tensor.shape[2] \
            * block_k
        for n, c in rng.integers(0, (block_n, block_k), (200, 2)):
            offset = n * row_bytes + 2 * c
            offset ^= ((offset >> 7) & (row_bytes // 16 - 1)) << 4
            assert tile[offset // 2] == weights[
                conv, tap, first + c, n].to(torch.bfloat16)


@pytest.mark.parametrize('tiles', [1, 2, 4])
@pytest.mark.parametrize('dilation', DILATIONS)
@pytest.mark.parametrize('kernel_size', [3, 7, 11])
@pytest.mark.parametrize('channels', [256, 128, 64, 32, 48])
def test_tile_plan_fits_shared_memory(
    channels, kernel_size, dilation, tiles
):
    plan = resblock.tile_plan(channels, kernel_size, dilation, tiles)
    assert plan['shared_bytes'] <= resblock.SHARED_LIMIT == 232448
    assert plan['rows'] == plan['block_m'] + (kernel_size - 1) * dilation
    assert plan['block_m'] == 64 * tiles
    assert plan['block_n'] in (32, 64, 128)
    # The ring, two input buffers and the alignment slack, as the kernel
    # lays them out
    input_bytes = -(-plan['rows'] * plan['block_k'] * 2 // 1024) * 1024
    staging = plan['block_m'] * (plan['block_n'] * 2 + 16)
    assert plan['shared_bytes'] == 2048 + \
        3 * plan['block_n'] * plan['block_k'] * 2 + \
        max(2 * input_bytes, staging)
    # The intermediate of a fused pair fits where the input buffers lay
    pair_rows = plan['block_m'] + kernel_size - 1
    assert plan['padded'] // plan['block_k'] > 2 or \
        plan['padded'] // plan['block_k'] * \
        -(-pair_rows * plan['block_k'] * 2 // 1024) * 1024 <= 2 * input_bytes


def test_packed_weights_run_the_plain_chain_on_cpu():
    x, weights, biases = _block(5, 2, 50, 48, 7)
    packed = resblock.pack_weights(
        torch.from_numpy(weights), torch.from_numpy(biases))
    ours = resblock.fused_block(
        torch.from_numpy(x).to(torch.bfloat16), packed, None, DILATIONS, 0.1)
    np.testing.assert_array_equal(
        ours.float().numpy(), _ours(x, weights, biases, torch.bfloat16))


def _cached_block(channels=8, kernel_size=3):
    from promonet_tpu_torch.models.hifigan import Block
    block = Block(channels, kernel_size, DILATIONS, 0.1)
    with torch.no_grad():
        block.weight.normal_()
        block.bias.normal_()
    return block


def test_block_cache_is_kept_between_calls():
    block = _cached_block()
    assert block.packed() is block.packed()
    unpacked, biases = resblock.unpack_weights(block.packed())
    assert torch.equal(unpacked, block.weight.detach().to(torch.bfloat16))
    assert torch.equal(biases, block.bias.detach().to(torch.bfloat16))


@pytest.mark.parametrize('change', ['load_state_dict', 'to', 'in_place'])
def test_block_cache_is_rebuilt_when_the_parameters_change(change):
    block = _cached_block()
    before = block.packed()
    if change == 'load_state_dict':
        state = {name: value + 1 for name, value in
                 block.state_dict().items()}
        block.load_state_dict(state)
    elif change == 'to':
        # No second device here: a dtype round trip replaces the
        # parameters' storage as `.to(device)` does
        block.to(torch.float64).to(torch.float32)
        with torch.no_grad():
            block.weight.mul_(2.)
    else:
        with torch.no_grad():
            block.bias.add_(1.)
    after = block.packed()
    assert after is not before
    unpacked, biases = resblock.unpack_weights(after)
    assert torch.equal(unpacked, block.weight.detach().to(torch.bfloat16))
    assert torch.equal(biases, block.bias.detach().to(torch.bfloat16))
