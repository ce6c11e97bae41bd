"""CARGAN: a HiFi-GAN conditioned on the samples before it

Counterpart of `promonet_tpu/models/cargan.py`. An MLP (`Autoregressive`:
three dense layers, each followed by a leaky ReLU of slope 0.1) encodes
the previous CARGAN_INPUT_SIZE samples into CARGAN_OUTPUT_SIZE channels,
which are repeated over the frames and concatenated onto the HiFi-GAN's
input features. As in the JAX package, the generator does not build it
(`Generator` refuses MODEL='cargan'): it is a module of its own, over
(B, T, C) features. Its HiFi-GAN is the port's, so on the card in bf16
its twelve Blocks are the residual-block kernel (K1).
"""
import torch
from torch import nn

from .. import config as config_module
from .hifigan import HiFiGAN
from .modules import Dense, leaky_relu


class Autoregressive(nn.Module):
    """Previous samples (B, 1, S) → (B, output_size) encoding"""

    def __init__(self, input_size=512, hidden_size=256, output_size=128):
        super().__init__()
        self.layers = nn.ModuleList([
            Dense(input_size, hidden_size, bias=True),
            Dense(hidden_size, hidden_size, bias=True),
            Dense(hidden_size, output_size, bias=True)])

    def forward(self, previous_samples, dtype=torch.float32):
        x = previous_samples.reshape(previous_samples.shape[0], -1).to(dtype)
        for layer in self.layers:
            x = leaky_relu(layer(x, dtype), 0.1)
        return x


class CARGAN(nn.Module):
    """(B, T, num_features) features and (B, 1, global_channels) global
    features → (B, T * HOPSIZE, 1) float32 audio"""

    def __init__(self, num_features, global_channels, config=None):
        super().__init__()
        config = config_module.default() if config is None else config
        self.input_size = config.CARGAN_INPUT_SIZE
        self.autoregressive = Autoregressive(
            config.CARGAN_INPUT_SIZE, config.CARGAN_HIDDEN_SIZE,
            config.CARGAN_OUTPUT_SIZE)
        self.hifigan = HiFiGAN(
            num_features + config.CARGAN_OUTPUT_SIZE,
            global_channels,
            initial_size=config.HIFIGAN_UPSAMPLE_INITIAL_SIZE,
            upsample_kernel_sizes=tuple(config.HIFIGAN_UPSAMPLE_KERNEL_SIZES),
            upsample_rates=tuple(config.HIFIGAN_UPSAMPLE_RATES),
            resblock_kernel_sizes=tuple(config.HIFIGAN_RESBLOCK_KERNEL_SIZES),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in config.HIFIGAN_RESBLOCK_DILATION_SIZES),
            lrelu_slope=config.LRELU_SLOPE)

    def forward(
        self, features, global_features, previous_samples=None,
        dtype=torch.float32
    ):
        """
        Arguments
            features: (B, T, num_features)
            global_features: (B, 1, global_channels)
            previous_samples: (B, 1, CARGAN_INPUT_SIZE) audio before the
                first frame; None is silence
            dtype: the compute dtype
        """
        batch, frames, _ = features.shape
        if previous_samples is None:
            previous_samples = torch.zeros(
                (batch, 1, self.input_size), dtype=torch.float32,
                device=features.device)
        context = self.autoregressive(previous_samples, dtype)
        # Both exact in float32; the input convolution rounds to dtype
        context = context[:, None, :].expand(batch, frames, -1)
        features = torch.cat((features.float(), context.float()), -1)
        return self.hifigan(features, global_features, dtype)
