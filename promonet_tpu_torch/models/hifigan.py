"""HiFi-GAN vocoder backbone (counterpart of `models/hifigan.py`)

Input conv and speaker-conditioning conv, then four upsampling stages
(leaky ReLU, transposed conv, average of three dilated residual
Blocks), then leaky ReLU, output conv and tanh. Activations are
(B, T, C). At inference (train=False) the Blocks run through
`ops.resblock.fused_block`: the CUDA kernel for CUDA tensors at every
width and length, the plain chain for CPU tensors. In training
(train=True), as in the JAX package, no Block reaches the kernel, which
has no backward: each runs the differentiable chain of `train_block`
(cuDNN convolutions on the card), recomputed in the backward pass under
`torch.utils.checkpoint` when `remat` is set.
"""
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.resblock import Packed, fused_block, pack_weights
from .modules import Conv1d, ConvTranspose1d, leaky_relu


def receptive_field_frames(
        upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_rates=(8, 8, 2, 2),
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5))):
    """Conditioning receptive field of the HiFi-GAN stack, in input frames

    Accumulated back from one output sample: each stride-1 convolution
    widens the window by (k - 1) * dilation, each transposed upsampling
    divides it by its rate (plus its kernel's spill), and the parallel
    residual branches take the widest kernel. The full extent, both
    sides: it bounds how many trailing frames of output a change to the
    last input frame can reach.
    """
    field = 1 + 6  # output conv, kernel 7
    for kernel, rate in zip(
        reversed(upsample_kernel_sizes), reversed(upsample_rates)
    ):
        field += max(
            sum((k - 1) * d + (k - 1) for d in dilations)
            for k, dilations in zip(
                resblock_kernel_sizes, resblock_dilation_sizes))
        field = -(-(field + kernel - 1) // rate) + 1
    return field + 6  # input conv, kernel 7


def train_block(x, weight, bias, dilations, slope, dtype):
    """A Block's chain, differentiable: `F.conv1d` in `dtype`

    Rounds where the JAX package's training lowering does: each
    convolution accumulates in float32 and returns `dtype`, and its bias
    and the residual are added in `dtype`.

    Arguments
        x: (B, T, C)
        weight: (2 * len(dilations), k, C, C) [conv][tap][in][out]
        bias: (2 * len(dilations), C)
    """
    k = weight.shape[1]
    # (conv, k, in, out) → (conv, out, in, k); activations (B, C, T)
    weight = weight.to(dtype).permute(0, 3, 2, 1)
    bias = bias.to(dtype)[:, :, None]
    x = x.to(dtype).transpose(1, 2)
    for i, dilation in enumerate(dilations):
        t = F.conv1d(
            leaky_relu(x, slope), weight[2 * i],
            padding=(k - 1) // 2 * dilation, dilation=dilation) + bias[2 * i]
        t = F.conv1d(
            leaky_relu(t, slope), weight[2 * i + 1],
            padding=(k - 1) // 2) + bias[2 * i + 1]
        x = x + t
    return x.transpose(1, 2)


class Block(nn.Module):
    """Dilated residual unit: the six convolutions of one kernel size

    `weight` is (2 * len(dilations), k, C, C) in [conv][tap][in][out]
    order, the layout of the kernel and of the JAX package's effective
    kernels; conv 2n has dilation dilations[n], conv 2n + 1 dilation 1.
    """

    def __init__(self, channels, kernel_size, dilations, slope, remat=False):
        super().__init__()
        # Each convolution weight-normed per output channel over (k, in)
        self.norm_axes = (1, 2)
        self.remat = remat
        self.dilations = tuple(dilations)
        self.slope = slope
        self.fan_in = channels * kernel_size
        self.weight = nn.Parameter(torch.empty(
            2 * len(dilations), kernel_size, channels, channels))
        self.bias = nn.Parameter(torch.empty(2 * len(dilations), channels))

        self._packed = None

    def freeze(self):
        """Pack the parameters once into buffers that `packed` serves from
        from then on, whatever the parameters become: for a program
        exported with `torch.export`, which holds them as constants"""
        with torch.no_grad():
            packed = pack_weights(self.weight, self.bias)
        self.register_buffer('packed_tiles', packed.tensor, persistent=False)
        self.register_buffer(
            'packed_biases', packed.biases, persistent=False)

    def packed(self):
        """The parameters packed for the CUDA kernel, made once

        Rebuilt when either parameter was written to (`load_state_dict`,
        an optimizer step) or lies elsewhere (`.to(device)`), unless the
        Block was frozen (`freeze`).
        """
        if hasattr(self, 'packed_tiles'):
            return Packed(
                self.packed_tiles, self.packed_biases, self.weight.shape[2],
                self.weight.shape[1])
        key = (
            self.weight.device, self.weight.data_ptr(), self.weight._version,
            self.bias.data_ptr(), self.bias._version)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, pack_weights(self.weight, self.bias))
        return self._packed[1]

    def forward(self, x, dtype=torch.float32, train=False):
        if train:
            if self.remat:
                # The chain draws no random numbers: no generator state
                # to keep (reading one is refused inside a CUDA graph's
                # capture)
                return torch.utils.checkpoint.checkpoint(
                    train_block, x, self.weight, self.bias, self.dilations,
                    self.slope, dtype, use_reentrant=False,
                    preserve_rng_state=False)
            return train_block(
                x, self.weight, self.bias, self.dilations, self.slope, dtype)
        if x.device.type == 'cuda' and dtype == torch.bfloat16:
            return fused_block(
                x.to(dtype), self.packed(), None, self.dilations, self.slope)
        return fused_block(
            x.to(dtype), self.weight.to(dtype), self.bias,
            self.dilations, self.slope)


class Stage(nn.Module):
    """Leaky ReLU → transposed upsample → average of parallel Blocks"""

    def __init__(self, in_channels, out_channels, upsample_kernel_size,
                 upsample_rate, kernel_sizes, dilation_sizes, slope,
                 remat=False):
        super().__init__()
        self.slope = slope
        self.upsample = ConvTranspose1d(
            in_channels, out_channels, upsample_kernel_size,
            stride=upsample_rate,
            padding=(upsample_kernel_size - upsample_rate) // 2)
        self.blocks = nn.ModuleList(
            Block(out_channels, kernel_size, dilations, slope, remat)
            for kernel_size, dilations in zip(kernel_sizes, dilation_sizes))

    def forward(self, x, dtype=torch.float32, train=False):
        x = self.upsample(leaky_relu(x, self.slope), dtype)
        total = None
        for block in self.blocks:
            out = block(x, dtype, train)
            total = out if total is None else total + out
        return total / len(self.blocks)


class HiFiGAN(nn.Module):
    """(B, T, num_features) features → (B, T * prod(rates), 1) audio"""

    def __init__(
        self,
        num_features,
        global_channels,
        initial_size=512,
        upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_rates=(8, 8, 2, 2),
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        lrelu_slope=0.1,
        remat=False
    ):
        super().__init__()
        self.slope = lrelu_slope
        self.input_conv = Conv1d(num_features, initial_size, 7, padding=3)
        self.global_conv = Conv1d(global_channels, initial_size, 1)
        stages = []
        channels = initial_size
        for kernel_size, rate in zip(upsample_kernel_sizes, upsample_rates):
            stages.append(Stage(
                channels, channels // 2, kernel_size, rate,
                resblock_kernel_sizes, resblock_dilation_sizes, lrelu_slope,
                remat))
            channels //= 2
        self.stages = nn.ModuleList(stages)
        self.output_conv = Conv1d(channels, 1, 7, padding=3, bias=False)

    def forward(self, features, global_features, dtype=torch.float32,
                train=False):
        """
        Arguments
            features: (B, T, num_features)
            global_features: (B, 1, global_channels)
            train: the differentiable route (no kernel), see the module
        """
        x = self.input_conv(features, dtype)
        x = x + self.global_conv(global_features, dtype)
        for stage in self.stages:
            x = stage(x, dtype, train)
        x = self.output_conv(leaky_relu(x, self.slope), dtype)
        return torch.tanh(x.float())
