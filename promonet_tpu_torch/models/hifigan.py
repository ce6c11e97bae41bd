"""HiFi-GAN vocoder backbone (counterpart of `models/hifigan.py`)

Input conv and speaker-conditioning conv, then four upsampling stages
(leaky ReLU, transposed conv, average of three dilated residual
Blocks), then leaky ReLU, output conv and tanh. Activations are
(B, T, C). The Blocks run through `ops.resblock.fused_block`: the CUDA
kernel for CUDA tensors at every width and length, the plain chain for
CPU tensors.
"""
import torch
from torch import nn

from ..ops.resblock import fused_block
from .modules import Conv1d, ConvTranspose1d, leaky_relu


class Block(nn.Module):
    """Dilated residual unit: the six convolutions of one kernel size

    `weight` is (2 * len(dilations), k, C, C) in [conv][tap][in][out]
    order, the layout of the kernel and of the JAX package's effective
    kernels; conv 2n has dilation dilations[n], conv 2n + 1 dilation 1.
    """

    def __init__(self, channels, kernel_size, dilations, slope):
        super().__init__()
        self.dilations = tuple(dilations)
        self.slope = slope
        self.fan_in = channels * kernel_size
        self.weight = nn.Parameter(torch.empty(
            2 * len(dilations), kernel_size, channels, channels))
        self.bias = nn.Parameter(torch.empty(2 * len(dilations), channels))

    def forward(self, x, dtype=torch.float32):
        return fused_block(
            x.to(dtype), self.weight.to(dtype), self.bias,
            self.dilations, self.slope)


class Stage(nn.Module):
    """Leaky ReLU → transposed upsample → average of parallel Blocks"""

    def __init__(self, in_channels, out_channels, upsample_kernel_size,
                 upsample_rate, kernel_sizes, dilation_sizes, slope):
        super().__init__()
        self.slope = slope
        self.upsample = ConvTranspose1d(
            in_channels, out_channels, upsample_kernel_size,
            stride=upsample_rate,
            padding=(upsample_kernel_size - upsample_rate) // 2)
        self.blocks = nn.ModuleList(
            Block(out_channels, kernel_size, dilations, slope)
            for kernel_size, dilations in zip(kernel_sizes, dilation_sizes))

    def forward(self, x, dtype=torch.float32):
        x = self.upsample(leaky_relu(x, self.slope), dtype)
        total = None
        for block in self.blocks:
            out = block(x, dtype)
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
        lrelu_slope=0.1
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
                resblock_kernel_sizes, resblock_dilation_sizes, lrelu_slope))
            channels //= 2
        self.stages = nn.ModuleList(stages)
        self.output_conv = Conv1d(channels, 1, 7, padding=3, bias=False)

    def forward(self, features, global_features, dtype=torch.float32):
        """
        Arguments
            features: (B, T, num_features)
            global_features: (B, 1, global_channels)
        """
        x = self.input_conv(features, dtype)
        x = x + self.global_conv(global_features, dtype)
        for stage in self.stages:
            x = stage(x, dtype)
        x = self.output_conv(leaky_relu(x, self.slope), dtype)
        return torch.tanh(x.float())
