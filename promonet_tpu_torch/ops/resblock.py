"""HiFi-GAN dilated residual block (counterpart of `ops/resblock.py`)

One Block is a chain of six stride-1 convolutions over (B, T, C)
activations: for each dilation d, lrelu → conv(k, d) + b → lrelu →
conv(k, 1) + b → residual add. `fused_block` runs it with the
hand-written CUDA kernel (`csrc/resblock.cu`) for a CUDA tensor, and
with the plain chain `reference_block` for a CPU tensor. The kernel
replaces the Pallas kernel `promonet_tpu/ops/resblock.py::_kernel`;
its source note gives the design and the bound.

Both versions round where the JAX package does
(`conv1d_shifted_dots`, `reference_block`): products accumulate in
float32, the sum is cast to the compute dtype, and the bias and the
residual are added in that dtype. The leaky-ReLU slope is rounded to
the compute dtype first, as JAX multiplies by a weakly typed scalar.
"""
import ctypes

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


def fused_block(x, weights, biases, dilations, slope):
    """Dilated residual block (HiFi-GAN Block semantics)

    Arguments
        x: (B, T, C) activations in the compute dtype
        weights: (2 * len(dilations), k, C, C) effective conv kernels
        biases: (2 * len(dilations), C)
        dilations: dilation schedule, e.g. (1, 3, 5)
        slope: leaky-ReLU slope

    Returns
        (B, T, C) in x's dtype
    """
    if x.device.type == 'cpu':
        return reference_block(x, weights, biases, dilations, slope, x.dtype)
    if x.device.type == 'cuda':
        return _block_cuda(x, weights, biases, dilations, slope)
    raise ValueError(f'No residual block for device {x.device}')


# Calls of the CUDA path; each call launches 2 * len(dilations) kernels
fused_block.launches = 0


def _block_cuda(x, weights, biases, dilations, slope):
    batch, frames, channels = x.shape
    stages, k = weights.shape[0], weights.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f'Residual block kernel takes bfloat16, got {x.dtype}')
    if tuple(weights.shape) != (2 * len(dilations), k, channels, channels) \
            or k % 2 == 0:
        raise ValueError(
            f'Weights of shape {tuple(weights.shape)} do not fit '
            f'{len(dilations)} dilations of {channels} channels')
    if tuple(biases.shape) != (stages, channels):
        raise ValueError(f'Biases of shape {tuple(biases.shape)}')
    for tensor in (weights, biases):
        if tensor.device != x.device:
            raise ValueError(f'Block parameters on {tensor.device}, not {x.device}')
    x = x.contiguous()
    weights = weights.to(torch.bfloat16).contiguous()
    biases = biases.to(torch.bfloat16).contiguous()
    slope = torch.tensor(slope, dtype=torch.bfloat16).item()
    hidden = torch.empty_like(x)
    out = torch.empty_like(x)
    function = _function()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        residual = x
        for i, dilation in enumerate(dilations):
            for stage, conv_dilation, source, add, target in (
                (2 * i, dilation, residual, None, hidden),
                (2 * i + 1, 1, hidden, residual, out),
            ):
                status = function(
                    source.data_ptr(),
                    weights[stage].data_ptr(),
                    biases[stage].data_ptr(),
                    None if add is None else add.data_ptr(),
                    target.data_ptr(),
                    batch,
                    frames,
                    channels,
                    k,
                    conv_dilation,
                    slope,
                    stream)
                _build.check(status, 'resblock')
            # After the first dilation the residual is updated in place
            residual = out
    fused_block.launches += 1
    return out


def _function():
    function = _build.library('resblock').resblock_conv
    function.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    function.restype = ctypes.c_int
    return function
