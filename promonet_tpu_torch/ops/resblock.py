"""HiFi-GAN dilated residual block (counterpart of `ops/resblock.py`)

One Block is a chain of six stride-1 convolutions over (B, T, C)
activations: for each dilation d, lrelu → conv(k, d) + b → lrelu →
conv(k, 1) + b → residual add. `fused_block` runs it with the
hand-written CUDA kernel (`csrc/resblock.cu`) for a CUDA tensor, and
with the plain chain `reference_block` for a CPU tensor. The kernel
replaces the Pallas kernel `promonet_tpu/ops/resblock.py::_kernel`;
its source note gives the design and the bound. It reads the weights
from the tiles of `pack_weights`, which a caller makes once per set of
parameters (`models.hifigan.Block` caches them).

Both versions round where the JAX package does
(`conv1d_shifted_dots`, `reference_block`): products accumulate in
float32, the sum is cast to the compute dtype, and the bias and the
residual are added in that dtype. The leaky-ReLU slope is rounded to
the compute dtype first, as JAX multiplies by a weakly typed scalar.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build


def leaky_relu(x, slope):
    """where(x >= 0, x, slope * x) with slope rounded to x's dtype"""
    slope = torch.tensor(slope, dtype=x.dtype).item()
    return torch.where(x >= 0, x, x * slope)


def conv1d_shifted(x, kernel, dilation, padding, dtype):
    """Stride-1 1-D convolution as k shifted float32 matmuls

    Arguments
        x: (B, T, C_in)
        kernel: (k, C_in, C_out)
        dilation / padding: conv parameters
        dtype: compute dtype; the float32 sum is cast to it
    """
    k = kernel.shape[0]
    length = x.shape[1] + 2 * padding - (k - 1) * dilation
    x = F.pad(x.to(dtype), (0, 0, padding, padding)).float()
    kernel = kernel.to(dtype).float()
    acc = None
    for j in range(k):
        part = torch.matmul(
            x[:, j * dilation:j * dilation + length], kernel[j])
        acc = part if acc is None else acc + part
    return acc.to(dtype)


def reference_block(x, weights, biases, dilations, slope, dtype):
    """The plain chain (the CPU path, and the kernel's yardstick)

    Arguments
        x: (B, T, C)
        weights: (2 * len(dilations), k, C, C) effective conv kernels
        biases: (2 * len(dilations), C)
    """
    k = weights.shape[1]
    x = x.to(dtype)
    for i, dilation in enumerate(dilations):
        t = leaky_relu(x, slope)
        t = conv1d_shifted(
            t, weights[2 * i], dilation, (k - 1) // 2 * dilation, dtype)
        t = t + biases[2 * i].to(dtype)
        t = leaky_relu(t, slope)
        t = conv1d_shifted(t, weights[2 * i + 1], 1, (k - 1) // 2, dtype)
        t = t + biases[2 * i + 1].to(dtype)
        x = x + t
    return x


# Geometry of `csrc/resblock.cu`: weight tiles in its ring, time rows per
# row tile, and the shared memory a Hopper block may take
STAGES = 3
ROWS_PER_TILE = 64
SHARED_LIMIT = 232448


def padded_channels(channels):
    """The width the kernel runs a block of `channels` at: 32, 64 or a
    multiple of 128 (activations, weights and biases are zero-padded,
    which is exact: a padded channel stays zero through the chain)"""
    if channels <= 32:
        return 32
    if channels <= 64:
        return 64
    return -(-channels // 128) * 128


def tile_shape(padded):
    """(output channels per block, input channels per slice) at a width"""
    return (padded, padded) if padded <= 64 else (128, 64)


def tile_plan(channels, kernel_size, dilation, tiles=2):
    """Tiles and shared memory of one `csrc/resblock.cu` launch

    Mirrors the kernel: a ring of STAGES weight tiles of (block_n,
    block_k) bf16, and two buffers (three for k = 1) of the input rows
    of one slice, block_m rows plus the halo, each rounded up to 1 KB
    (the intermediate of a fused pair and the staged output tile later
    take their place), plus 1 KB to align the whole and 1 KB for the
    ring's barriers.
    """
    padded = padded_channels(channels)
    block_n, block_k = tile_shape(padded)
    block_m = tiles * ROWS_PER_TILE
    rows = block_m + (kernel_size - 1) * dilation
    input_bytes = -(-rows * block_k * 2 // 1024) * 1024
    buffers = 2 if kernel_size >= STAGES - 1 else 3
    # The epilogue stages the output tile where the input buffers lay
    staging = block_m * (block_n * 2 + 16)
    return dict(
        padded=padded, block_m=block_m, block_n=block_n, block_k=block_k,
        rows=rows,
        shared_bytes=2048 + STAGES * block_n * block_k * 2 +
        max(buffers * input_bytes, staging))


def _swizzle_index(block_n, block_k):
    """Source chunk of each 16-byte chunk of a (block_n, block_k) bf16
    tile in the K-major swizzled image wgmma reads: chunk c of row n lies
    at chunk c ^ (line(n) mod chunks), line(n) the row's 128-byte line.
    The map is its own inverse."""
    row_bytes = block_k * 2
    chunks = row_bytes // 16
    rows = torch.arange(block_n)[:, None]
    return torch.arange(chunks)[None, :] ^ (
        (rows * row_bytes // 128) & (chunks - 1))


class Packed:
    """A Block's parameters in the layout `csrc/resblock.cu` reads

    tensor: (convs, C' / block_n, C' / block_k, k, block_n, block_k)
        bf16, C' the padded width: one contiguous swizzled tile per (n
        tile, slice of input channels, tap), [out][in] inside a tile
    biases: (convs, C') bf16
    """

    def __init__(self, tensor, biases, channels, kernel_size):
        self.tensor = tensor
        self.biases = biases
        self.channels = channels
        self.kernel_size = kernel_size
        self.padded = biases.shape[1]
        self.device = tensor.device


def pack_weights(weights, biases):
    """Pack (convs, k, C, C) [conv][tap][in][out] kernels and (convs, C)
    biases for the kernel, once; see `Packed`"""
    convs, k, channels, _ = weights.shape
    padded = padded_channels(channels)
    block_n, block_k = tile_shape(padded)
    grown = weights.new_zeros((convs, k, padded, padded), dtype=torch.bfloat16)
    grown[:, :, :channels, :channels] = weights.to(torch.bfloat16)
    # [conv][tap][slice][in][n tile][out] → [conv][n tile][slice][tap][out][in]
    tiles = grown.reshape(
        convs, k, padded // block_k, block_k, padded // block_n, block_n
    ).permute(0, 4, 2, 1, 5, 3)
    chunks = block_k // 8
    index = _swizzle_index(block_n, block_k).to(weights.device)
    tiles = tiles.reshape(*tiles.shape[:4], block_n, chunks, 8)[
        ..., torch.arange(block_n, device=weights.device)[:, None], index, :]
    grown_biases = biases.new_zeros((convs, padded), dtype=torch.bfloat16)
    grown_biases[:, :channels] = biases.to(torch.bfloat16)
    return Packed(
        tiles.reshape(*tiles.shape[:4], block_n, block_k).contiguous(),
        grown_biases, channels, k)


def unpack_weights(packed):
    """(convs, k, C, C) bf16 kernels and (convs, C) bf16 biases back from
    a `Packed` (the inverse of `pack_weights` up to the bf16 cast)"""
    tiles = packed.tensor
    convs, n_tiles, slices, k, block_n, block_k = tiles.shape
    index = _swizzle_index(block_n, block_k).to(tiles.device)
    tiles = tiles.reshape(convs, n_tiles, slices, k, block_n, block_k // 8, 8)[
        ..., torch.arange(block_n, device=tiles.device)[:, None], index, :]
    grown = tiles.reshape(convs, n_tiles, slices, k, block_n, block_k).permute(
        0, 3, 2, 5, 1, 4).reshape(convs, k, packed.padded, packed.padded)
    channels = packed.channels
    return (grown[:, :, :channels, :channels].contiguous(),
            packed.biases[:, :channels].contiguous())


def fused_block(x, weights, biases, dilations, slope, tiles=None):
    """Dilated residual block (HiFi-GAN Block semantics)

    Arguments
        x: (B, T, C) activations in the compute dtype
        weights: (2 * len(dilations), k, C, C) effective conv kernels, or
            a `Packed` from `pack_weights` (then `biases` is not read):
            the CUDA path packs on every call otherwise
        biases: (2 * len(dilations), C)
        dilations: dilation schedule, e.g. (1, 3, 5)
        slope: leaky-ReLU slope
        tiles: row tiles (64 time rows each) per thread block of the
            kernel: 1 or 2, or 4 up to 64 channels; None chooses by
            `choose_tiles`

    Returns
        (B, T, C) in x's dtype
    """
    if x.device.type == 'cpu':
        if isinstance(weights, Packed):
            weights, biases = unpack_weights(weights)
        return reference_block(x, weights, biases, dilations, slope, x.dtype)
    if x.device.type == 'cuda':
        return _block_cuda(x, weights, biases, dilations, slope, tiles)
    raise ValueError(f'No residual block for device {x.device}')


# Calls of the CUDA path; each is one C call that launches
# `kernel_launches` kernels
fused_block.launches = 0


def kernel_launches(padded, dilations):
    """CUDA launches of one Block call: up to 128 channels one launch per
    dilation (both convolutions, the intermediate in shared memory),
    above that one per convolution"""
    return len(dilations) * (1 if padded <= 128 else 2)


def choose_tiles(padded):
    """Row tiles (64 time rows each) per thread block

    From the readings of `chip_smoke.py` on an H100 (`ms_by_tiles` of its
    `time` lines, main-path shapes): four at 32 channels, two at 64 and
    128, one above (there a 10240-frame stage has too few blocks of 128
    rows to fill the card evenly).
    """
    if padded <= 32:
        return 4
    return 2 if padded <= 128 else 1


def _block_cuda(x, weights, biases, dilations, slope, tiles):
    batch, frames, channels = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f'Residual block kernel takes bfloat16, got {x.dtype}')
    if batch < 1 or frames < 1:
        raise ValueError(f'Residual block over an empty {tuple(x.shape)}')
    if not isinstance(weights, Packed):
        if weights.dim() != 4 or tuple(biases.shape) != (
                weights.shape[0], weights.shape[3]):
            raise ValueError(
                f'Weights of shape {tuple(weights.shape)} and biases of '
                f'shape {tuple(biases.shape)} do not fit')
        if biases.device != weights.device:
            raise ValueError(
                f'Block parameters on {weights.device} and {biases.device}')
        weights = pack_weights(weights, biases)
    k = weights.kernel_size
    if weights.tensor.shape[0] != 2 * len(dilations) or k % 2 == 0 \
            or weights.channels != channels:
        raise ValueError(
            f'{weights.tensor.shape[0]} kernels of size {k} over '
            f'{weights.channels} channels do not fit {len(dilations)} '
            f'dilations of {channels} channels')
    if weights.device != x.device:
        raise ValueError(
            f'Block parameters on {weights.device}, not {x.device}')
    padded = weights.padded
    if tiles is None:
        tiles = choose_tiles(padded)
    if tiles not in ((1, 2, 4) if padded <= 64 else (1, 2)):
        raise ValueError(f'{tiles} row tiles at {padded} channels')
    if tiles * ROWS_PER_TILE < k:
        raise ValueError(
            f'Kernel size {k} leaves no output row in {tiles} row tiles')
    for dilation in dilations:
        plan = tile_plan(channels, k, dilation, tiles)
        if plan['shared_bytes'] > SHARED_LIMIT:
            raise ValueError(
                f'Kernel size {k} at dilation {dilation} needs '
                f"{plan['shared_bytes']} bytes of shared memory")
    x = F.pad(x, (0, padded - channels)) if padded != channels \
        else x.contiguous()
    slope = torch.tensor(slope, dtype=torch.bfloat16).item()
    hidden = torch.empty_like(x)
    out = torch.empty_like(x)
    function = _function()
    with torch.cuda.device(x.device):
        status = function(
            x.data_ptr(),
            weights.tensor.data_ptr(),
            weights.biases.data_ptr(),
            hidden.data_ptr(),
            out.data_ptr(),
            batch,
            frames,
            padded,
            k,
            (ctypes.c_int * len(dilations))(*dilations),
            len(dilations),
            slope,
            tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(status, 'resblock')
    fused_block.launches += 1
    return out if padded == channels else out[..., :channels].contiguous()


@functools.lru_cache(maxsize=None)
def _function():
    function = _build.library('resblock').resblock_block
    function.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    function.restype = ctypes.c_int
    return function
