"""GAN discriminators (counterpart of `promonet_tpu/models/discriminator.py`)

`Discriminator` builds the configured set, in the JAX package's order:
multi-period (periods 2, 3, 5, 7, 11), multi-scale, multi-resolution,
complex multi-band and the FARGAN magnitude discriminators; it returns
(logits_real, logits_fake, feature_maps_real, feature_maps_fake), lists
over the discriminators. Every convolution is weight-normed and trained
as (v, g): the modules hold `weight_v`, `weight_g` and `bias` and
materialise v * (g / sqrt(sum(v^2) + 1e-12)) on each call, as the JAX
package does. Parameters are float32; a discriminator computes in the
generator's dtype (`PRECISION`).

Layouts are PyTorch's: the 2-D discriminators run over (B, C, H, W), the
multi-scale one over (B, T, C) as the JAX package does; a feature map is
the JAX package's NHWC map transposed to NCHW. The STFT front ends use
no window (rectangular), as the reference's in-discriminator `torch.stft`
calls do. Under `remat` each discriminator is recomputed in the backward
pass (`torch.utils.checkpoint`), as `nn.remat` does in the JAX package.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import stft as stft_ops
from .modules import leaky_relu, weight_norm


class WNConv2d(nn.Module):
    """Weight-normed 2-D convolution over (B, C, H, W)

    weight_v (out, in, kh, kw), weight_g (out, 1, 1, 1): normed per output
    channel over (in, kh, kw).
    """

    norm_axes = (1, 2, 3)

    def __init__(self, in_channels, out_channels, kernel_size, stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dilation = tuple(dilation)
        self.fan_in = in_channels * kernel_size[0] * kernel_size[1]
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x, dtype):
        weight = weight_norm(self.weight_v, self.weight_g, self.norm_axes)
        y = F.conv2d(
            x.to(dtype), weight.to(dtype), stride=self.stride,
            padding=self.padding, dilation=self.dilation)
        return y + self.bias.to(dtype)[:, None, None]


class WNConv1d(nn.Module):
    """Weight-normed 1-D convolution over (B, T, C), grouped

    weight_v (out, in // groups, k), weight_g (out, 1, 1).
    """

    norm_axes = (1, 2)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.fan_in = in_channels // groups * kernel_size
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x, dtype):
        weight = weight_norm(self.weight_v, self.weight_g, self.norm_axes)
        y = F.conv1d(
            x.to(dtype).transpose(1, 2), weight.to(dtype), stride=self.stride,
            padding=self.padding, groups=self.groups).transpose(1, 2)
        return y + self.bias.to(dtype)


###############################################################################
# Aggregate discriminator
###############################################################################


class Discriminator(nn.Module):
    """The configured discriminators

    Arguments
        config: a `config.Config`; its *_DISCRIMINATOR switches, LRELU_SLOPE,
            WINDOW_SIZE and HOPSIZE (the complex multi-band STFT),
            PRECISION (the compute dtype) and REMAT are read
    """

    def __init__(self, config):
        super().__init__()
        self.dtype = (
            torch.bfloat16 if config.PRECISION == 'bfloat16'
            else torch.float32)
        self.remat = bool(getattr(config, 'REMAT', False))
        slope = config.LRELU_SLOPE
        discriminators = []
        if config.MULTI_PERIOD_DISCRIMINATOR:
            discriminators += [
                DiscriminatorP(period, lrelu_slope=slope)
                for period in (2, 3, 5, 7, 11)]
        if config.MULTI_SCALE_DISCRIMINATOR:
            discriminators.append(DiscriminatorS(lrelu_slope=slope))
        if config.MULTI_RESOLUTION_DISCRIMINATOR:
            discriminators += [
                DiscriminatorR(resolution)
                for resolution in (
                    (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))]
        if config.COMPLEX_MULTIBAND_DISCRIMINATOR:
            discriminators.append(
                DiscriminatorCMB(config.WINDOW_SIZE, config.HOPSIZE))
        if config.FARGAN_DISCRIMINATOR:
            discriminators += [
                DiscriminatorMagFree((n, n // 4, n))
                for n in (64, 128, 256, 512, 1024, 2048)]
        self.discriminators = nn.ModuleList(discriminators)

    def forward(self, audio_real, audio_fake):
        """audio: (B, 1, T) float32. Returns four lists over the
        discriminators: real logits (B, -1), fake logits, real feature
        maps, fake feature maps"""
        logits_real, logits_fake = [], []
        feature_maps_real, feature_maps_fake = [], []
        for discriminator in self.discriminators:
            logit_real, fmap_real = self._call(discriminator, audio_real)
            logit_fake, fmap_fake = self._call(discriminator, audio_fake)
            logits_real.append(logit_real)
            logits_fake.append(logit_fake)
            feature_maps_real.append(fmap_real)
            feature_maps_fake.append(fmap_fake)
        return logits_real, logits_fake, feature_maps_real, feature_maps_fake

    def _call(self, discriminator, audio):
        if self.remat and torch.is_grad_enabled():
            # No discriminator draws random numbers: no generator state to
            # keep (reading one is refused inside a CUDA graph's capture)
            return torch.utils.checkpoint.checkpoint(
                discriminator, audio, self.dtype, use_reentrant=False,
                preserve_rng_state=False)
        return discriminator(audio, self.dtype)


###############################################################################
# Individual discriminators
###############################################################################


class DiscriminatorP(nn.Module):
    """Multi-period waveform discriminator

    Audio is reflect-padded on the right to a multiple of the period and
    viewed as (B, 1, T / p, p), so strided convolutions over the first
    spatial axis see period-aligned samples.
    """

    def __init__(self, period, kernel_size=5, stride=3, lrelu_slope=0.1):
        super().__init__()
        self.period = period
        self.slope = lrelu_slope
        pad = ((kernel_size - 1) // 2, 0)
        layers = [
            (1, 32, stride), (32, 128, stride), (128, 512, stride),
            (512, 1024, stride), (1024, 1024, 1)]
        self.convs = nn.ModuleList(
            WNConv2d(cin, cout, (kernel_size, 1), (s, 1), pad)
            for cin, cout, s in layers)
        self.convs.append(WNConv2d(1024, 1, (3, 1), padding=(1, 0)))

    def forward(self, x, dtype):
        batch, _, time = x.shape
        if time % self.period:
            x = F.pad(x, (0, self.period - time % self.period),
                      mode='reflect')
            time = x.shape[-1]
        x = x.reshape(batch, 1, time // self.period, self.period)
        feature_maps = []
        for conv in self.convs[:-1]:
            x = leaky_relu(conv(x, dtype), self.slope)
            feature_maps.append(x)
        x = self.convs[-1](x, dtype)
        feature_maps.append(x)
        return x.reshape(batch, -1), feature_maps


class DiscriminatorR(nn.Module):
    """Multi-resolution magnitude-spectrogram discriminator, over
    (B, 1, frequency, frames)"""

    def __init__(self, resolution, lrelu_slope=0.2):
        super().__init__()
        self.resolution = tuple(resolution)
        self.slope = lrelu_slope
        self.convs = nn.ModuleList(
            WNConv2d(1 if i == 0 else 32, 32, (3, 9), stride, (1, 4))
            for i, stride in enumerate(((1, 1), (1, 2), (1, 2), (1, 2))))
        self.convs.append(WNConv2d(32, 32, (3, 3), padding=(1, 1)))
        self.convs.append(WNConv2d(32, 1, (3, 3), padding=(1, 1)))

    def spectrogram(self, x):
        n_fft, hop, _ = self.resolution
        x = stft_ops.reflect_pad(x, (n_fft - hop) // 2)
        return stft_ops.stft(x[:, 0], n_fft, hop, magnitude=True)[:, None]

    def forward(self, x, dtype):
        x = self.spectrogram(x)
        feature_maps = []
        for conv in self.convs[:-1]:
            x = leaky_relu(conv(x, dtype), self.slope)
            feature_maps.append(x)
        x = self.convs[-1](x, dtype)
        feature_maps.append(x)
        return x.reshape(x.shape[0], -1), feature_maps


class DiscriminatorCMB(nn.Module):
    """Complex multi-band spectrogram discriminator (RVQGAN-style)

    The magnitude of a rectangular-window STFT of WINDOW_SIZE points, as
    (B, 1, frames, frequency), is split into five bands of its
    WINDOW_SIZE // 2 + 1 bins at int(fraction * bins); each band has its
    own stack of five convolutions, and the bands' outputs are joined
    along frequency before the last convolution.
    """

    bands = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_size, hopsize, channels=32, lrelu_slope=0.1):
        super().__init__()
        self.window_size = window_size
        self.hopsize = hopsize
        self.slope = lrelu_slope
        self.convs = nn.ModuleList()
        for _ in self.bands:
            for i, (kernel, stride, padding) in enumerate((
                ((3, 9), (1, 1), (1, 4)),
                ((3, 9), (1, 2), (1, 4)),
                ((3, 9), (1, 2), (1, 4)),
                ((3, 9), (1, 2), (1, 4)),
                ((3, 3), (1, 1), (1, 1)),
            )):
                self.convs.append(WNConv2d(
                    1 if i == 0 else channels, channels, kernel, stride,
                    padding))
        self.convs.append(WNConv2d(channels, 1, (3, 3), padding=(1, 1)))

    def spectrogram(self, x):
        """The five bands, each (B, 1, frames, bins of the band)"""
        x = stft_ops.reflect_pad(x, (self.window_size - self.hopsize) // 2)
        magnitude = stft_ops.stft(
            x[:, 0], self.window_size, self.hopsize, magnitude=True)
        magnitude = magnitude.transpose(1, 2)[:, None]
        bins = self.window_size // 2 + 1
        return [
            magnitude[..., int(low * bins):int(high * bins)]
            for low, high in self.bands]

    def forward(self, x, dtype):
        feature_maps, outputs = [], []
        layers = len(self.convs) // len(self.bands)
        for i, band in enumerate(self.spectrogram(x)):
            for conv in self.convs[i * layers:(i + 1) * layers]:
                band = leaky_relu(conv(band, dtype), self.slope)
                feature_maps.append(band)
            outputs.append(band)
        x = self.convs[-1](torch.cat(outputs, dim=-1), dtype)
        feature_maps.append(x)
        return x.reshape(x.shape[0], -1), feature_maps


class DiscriminatorS(nn.Module):
    """Multi-scale waveform discriminator (MelGAN-style), over (B, T, C)"""

    def __init__(self, lrelu_slope=0.1):
        super().__init__()
        self.slope = lrelu_slope
        layers = (
            (1, 16, 15, 1, 1, 7),
            (16, 64, 41, 4, 4, 20),
            (64, 256, 41, 4, 16, 20),
            (256, 1024, 41, 4, 64, 20),
            (1024, 1024, 41, 4, 256, 20),
            (1024, 1024, 5, 1, 1, 2))
        self.convs = nn.ModuleList(
            WNConv1d(cin, cout, kernel, stride, padding, groups)
            for cin, cout, kernel, stride, groups, padding in layers)
        self.convs.append(WNConv1d(1024, 1, 3, padding=1))

    def forward(self, x, dtype):
        x = x.transpose(1, 2)
        feature_maps = []
        for conv in self.convs[:-1]:
            x = leaky_relu(conv(x, dtype), self.slope)
            feature_maps.append(x)
        x = self.convs[-1](x, dtype)
        feature_maps.append(x)
        return x.reshape(x.shape[0], -1), feature_maps


###############################################################################
# FARGAN discriminator
###############################################################################


def gen_filterbank(n, sample_rate, keep_size=False):
    """ERB-spaced smoothing filterbank, (n or n + 1, n + 1) float32: row i
    weighs the n + 1 bins of 0 to sample_rate / 2 by their distance from
    bin i in ERBs (B.C.J. Moore, An Introduction to the Psychology of
    Hearing, 5th ed.), normalised to sum to one"""
    in_freq = (np.arange(n + 1, dtype='float32') / n * sample_rate / 2)[None]
    m = n + 1 if keep_size else n
    out_freq = (np.arange(m, dtype='float32') / n * sample_rate / 2)[:, None]
    erb = 24.7 + .108 * in_freq
    delta = np.abs(in_freq - out_freq) / erb
    center = (delta < .5).astype('float32')
    response = -12 * center * delta ** 2 + (1 - center) * (3 - 12 * delta)
    energy = 10. ** (response / 10.)
    return torch.from_numpy(energy / energy.sum(axis=1, keepdims=True))


def create_3x3_conv_plan(num_layers, f_stretch, f_down, t_stretch, t_down):
    """((stride), (dilation), (padding)) of each layer, as (frequency,
    time) pairs (the JAX package's plan)"""

    def process_dimension(n_layers, stretch, down):
        stack_layers = n_layers - 1
        stride_layers = min(min(down, stretch), stack_layers)
        dilation_layers = max(
            min(stack_layers - stride_layers - 1, stretch - stride_layers), 0)
        final_stride = 2 ** (max(down - stride_layers, 0))

        strides, dilations, paddings = [], [], []
        processed, current_dilation = 0, 1
        for _ in range(stride_layers):
            strides.append(2)
            dilations.append(1)
            paddings.append(1)
            processed += 1
        if processed < stack_layers:
            strides.append(1)
            dilations.append(1)
            paddings.append(1)
            processed += 1
        for _ in range(dilation_layers):
            strides.append(1)
            current_dilation *= 2
            dilations.append(current_dilation)
            paddings.append(current_dilation)
            processed += 1
        while processed < n_layers - 1:
            strides.append(1)
            dilations.append(current_dilation)
            paddings.append(current_dilation)
            processed += 1
        strides.append(final_stride)
        dilations.append(current_dilation)
        paddings.append(current_dilation)
        return strides, dilations, paddings

    t = process_dimension(num_layers, t_stretch, t_down)
    f = process_dimension(num_layers, f_stretch, f_down)
    return [
        ((f[0][i], t[0][i]), (f[1][i], t[1][i]), (f[2][i], t[2][i]))
        for i in range(num_layers)]


def frequency_positional_embedding(x):
    """(B, C, T, F) ⊕ sin and cos of the frequency position: (B, C + 2,
    T, F)"""
    n = x.shape[-1]
    args = torch.arange(n, dtype=x.dtype, device=x.device) * math.pi * 2 / n
    shape = (x.shape[0], 1, x.shape[2], n)
    return torch.cat(
        (x, torch.sin(args).expand(shape), torch.cos(args).expand(shape)),
        dim=1)


class DiscriminatorMagFree(nn.Module):
    """FARGAN's dB-magnitude discriminator with frequency positions, over
    (B, C, frames, frequency)"""

    def __init__(self, resolution, num_channels=16, max_channels=256,
                 num_layers=5):
        super().__init__()
        self.resolution = tuple(resolution)
        n_fft = resolution[0]
        stretch = {64: 0, 128: 1, 256: 2, 512: 3, 1024: 4, 2048: 5}[n_fft]
        # The plan is (frequency, time); the layout here is (time,
        # frequency)
        self.plan = [
            tuple((pair[1], pair[0]) for pair in layer)
            for layer in create_3x3_conv_plan(
                num_layers + 1, stretch, stretch, 0, 0)]
        self.convs = nn.ModuleList()
        channels, out_channels = 1, num_channels
        for stride, dilation, padding in self.plan[:-1]:
            self.convs.append(WNConv2d(
                channels + 2, out_channels, (3, 3), stride, padding,
                dilation))
            channels = out_channels
            out_channels = min(stride[0] * stride[1] * out_channels,
                               max_channels)
        stride, dilation, padding = self.plan[-1]
        self.convs.append(WNConv2d(
            channels + 2, 1, (3, 3), stride, padding, dilation))

    def spectrogram(self, x):
        n_fft, hop, window_length = self.resolution
        window = stft_ops.hann_window(window_length, device=x.device)
        magnitude = stft_ops.stft(
            x[:, 0], n_fft, hop, window=window, center=True, magnitude=True)
        # amplitude_to_DB(multiplier=20, amin=1e-5, top_db=80) over the
        # whole batch
        db = 20. * torch.log10(torch.clamp(magnitude, min=1e-5))
        db = torch.maximum(db, db.max() - 80.)
        return db.transpose(1, 2)[:, None]

    def forward(self, x, dtype):
        x = self.spectrogram(x).to(dtype)
        outputs = []
        for conv in self.convs[:-1]:
            x = torch.relu(conv(frequency_positional_embedding(x), dtype))
            outputs.append(x)
        x = torch.sigmoid(
            self.convs[-1](frequency_positional_embedding(x), dtype))
        return x.reshape(x.shape[0], -1), outputs

