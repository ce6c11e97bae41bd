"""Vocos vocoder backbone (counterpart of `promonet_tpu/models/vocos.py`)

Input and speaker-conditioning convolutions, a ConvNeXt stack, then a
head that predicts log-magnitude and phase of an STFT, which the inverse
STFT turns into audio. Activations are (B, T, C). As in the JAX package,
GELU is the tanh approximation (Flax's default), LayerNorm's epsilon is
1e-6 and LayerNorm computes in float32.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stft as stft_ops
from .modules import Conv1d, Dense


def layer_norm(norm, x, dtype):
    """`norm` (an nn.LayerNorm) in float32, rounded to dtype"""
    return norm(x.float()).to(dtype)


class ConvNeXtBlock(nn.Module):
    """Depthwise conv → LayerNorm → pointwise MLP, scaled, plus residual"""

    def __init__(self, dim, pointwise_channels, layer_scale):
        super().__init__()
        self.depthwise = Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pointwise = Dense(dim, pointwise_channels, bias=True)
        self.project = Dense(pointwise_channels, dim, bias=True)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale)))

    def forward(self, x, dtype=torch.float32):
        y = layer_norm(self.norm, self.depthwise(x, dtype), dtype)
        y = F.gelu(self.pointwise(y, dtype), approximate='tanh')
        return x + self.gamma.to(dtype) * self.project(y, dtype)


class Vocos(nn.Module):
    """(B, T, num_features) features → (B, T * hop_length, 1) audio"""

    def __init__(
        self, num_features, global_channels, channels=512,
        pointwise_channels=1536, num_layers=6, n_fft=1024, hop_length=256
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.input_conv = Conv1d(num_features, channels, 7, padding=3)
        self.global_conv = Conv1d(global_channels, channels, 1)
        self.conv = Conv1d(channels, channels, 7, padding=3)
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(channels, pointwise_channels, 1 / num_layers)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(channels, eps=1e-6)
        self.head = Dense(channels, n_fft + 2, bias=True)

    def forward(self, features, global_features, dtype=torch.float32):
        x = self.input_conv(features, dtype)
        x = x + self.global_conv(global_features, dtype)
        x = layer_norm(self.norm, self.conv(x, dtype), dtype)
        for block in self.blocks:
            x = block(x, dtype)
        x = layer_norm(self.final_norm, x, dtype)
        magnitude, phase = self.head(x, dtype).float().chunk(2, dim=-1)
        spectrum = torch.polar(
            torch.clamp(torch.exp(magnitude), max=1e2), phase)
        window = stft_ops.hann_window(self.n_fft, device=x.device)
        audio = stft_ops.istft(
            spectrum.transpose(-1, -2), self.n_fft, self.hop_length, window)
        return audio[..., None]
