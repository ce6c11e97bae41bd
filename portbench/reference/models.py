"""The models of the reference, by the port's parameter names

Frozen copies at commit ce32675 of the plain paths of
`promonet_tpu_torch/models/modules.py` (`Conv1d`, `ConvTranspose1d`,
`Dense`, `same_padding`), `preprocess/pitch.py` (`PitchCNN`),
`preprocess/ppg.py` (`PPGEncoder`), `models/hifigan.py` (the Block
chain of `train_block`, `Stage`, `HiFiGAN`), `models/fargan.py` (the
inference frame loop) and `models/generator.py` (`Generator`: feature
preparation and speaker conditioning). Activations are (B, T, C), as
there, and every parameter has the port's name and layout, so the
harness's state dict loads into both. Arithmetic is float32; every
convolution, matrix product and recurrent cell takes its operands and
result through a `precision.Exact` or `precision.Float8`, and so do the
values the program keeps in its compute dtype between them (residual
sums, recurrent states, gated and squashed activations).
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import dsp
from .precision import EXACT


def leaky_relu(x, slope):
    return torch.where(x >= 0, x, x * slope)


def same_padding(length, kernel_size, stride):
    """(left, right) padding of Flax's 'SAME' convolutions"""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """1-D convolution over (B, T, C); weight (out, in // groups, k)"""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, dilation=1, precision=EXACT):
        super().__init__()
        self.stride, self.dilation, self.precision = stride, dilation, precision
        self.padding = (
            (padding, padding) if isinstance(padding, int) else tuple(padding))
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x):
        p = self.precision
        x = F.pad(p.operand(x).transpose(1, 2), self.padding)
        y = p.result(F.conv1d(
            x, p.operand(self.weight), stride=self.stride,
            dilation=self.dilation)).transpose(1, 2)
        return y if self.bias is None else y + self.bias


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution over (B, T, C); weight (in, out, k)"""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, precision=EXACT):
        super().__init__()
        self.stride, self.padding, self.precision = stride, padding, precision
        # Weight-normed per input channel in training (`train.normed`)
        self.norm_axes = (1, 2)
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        p = self.precision
        y = p.result(F.conv_transpose1d(
            p.operand(x).transpose(1, 2), p.operand(self.weight),
            stride=self.stride, padding=self.padding)).transpose(1, 2)
        return y + self.bias


class Dense(nn.Module):
    """Dense layer over (..., in); weight (out, in)"""

    def __init__(self, in_features, out_features, bias=False,
                 precision=EXACT):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        p = self.precision
        y = p.result(F.linear(p.operand(x), p.operand(self.weight)))
        return y if self.bias is None else y + self.bias


###############################################################################
# Feature extractors (preprocess/pitch.py, preprocess/ppg.py)
###############################################################################


class PitchCNN(nn.Module):
    """FCNF0-style framewise pitch-posterior CNN over 1024-sample frames"""

    def __init__(self, precision=EXACT, channels=(128, 32, 32, 64, 128, 256),
                 kernel_sizes=(32, 16, 8, 8, 8, 4), strides=(4, 2, 2, 1, 1, 1),
                 num_bins=256):
        super().__init__()
        self.convs = nn.ModuleList()
        length, previous = 1024, 1
        for features, kernel, stride in zip(channels, kernel_sizes, strides):
            self.convs.append(Conv1d(
                previous, features, kernel, stride=stride,
                precision=precision))
            previous = features
            length = -(-length // stride)
        self.norms = nn.ModuleList(
            nn.LayerNorm(features, eps=1e-6) for features in channels)
        self.output = Dense(length * previous, num_bins, bias=True,
                            precision=precision)

    def forward(self, frames):
        """frames (B, 1024) → logits (B, num_bins)"""
        x = frames[..., None]
        for conv, norm in zip(self.convs, self.norms):
            left, right = same_padding(
                x.shape[1], conv.weight.shape[-1], conv.stride)
            x = F.relu(norm(conv(F.pad(x, (0, 0, left, right)))))
        return self.output(x.reshape(x.shape[0], -1))


class PPGEncoder(nn.Module):
    """Frame-rate phoneme classifier over log-mels"""

    def __init__(self, precision=EXACT, num_mels=80, channels=256,
                 num_layers=6, num_phonemes=40, kernel_size=5):
        super().__init__()
        self.channels = channels
        padding = (kernel_size // 2, kernel_size - 1 - kernel_size // 2)
        self.convs = nn.ModuleList(
            Conv1d(num_mels if i == 0 else channels, channels, kernel_size,
                   padding=padding, precision=precision)
            for i in range(num_layers))
        self.norms = nn.ModuleList(
            nn.LayerNorm(channels, eps=1e-6) for _ in range(num_layers))
        self.output = Dense(channels, num_phonemes, bias=True,
                            precision=precision)

    def forward(self, mels):
        """mels (B, T, NUM_MELS) → log-posteriors (B, T, num_phonemes)"""
        x = mels
        for conv, norm in zip(self.convs, self.norms):
            y = F.gelu(norm(conv(x)), approximate='tanh')
            x = y if x.shape[-1] != self.channels else x + y
        return torch.log_softmax(self.output(x), dim=-1)


###############################################################################
# HiFi-GAN (models/hifigan.py)
###############################################################################


class Block(nn.Module):
    """Dilated residual unit; weight (2 * len(dilations), k, C, C) in
    [conv][tap][in][out] order, bias (2 * len(dilations), C)"""

    def __init__(self, channels, kernel_size, dilations, slope, precision):
        super().__init__()
        self.dilations, self.slope, self.precision = (
            tuple(dilations), slope, precision)
        # Weight-normed per output channel over (k, in) in training
        self.norm_axes = (1, 2)
        self.weight = nn.Parameter(torch.empty(
            2 * len(dilations), kernel_size, channels, channels))
        self.bias = nn.Parameter(torch.empty(2 * len(dilations), channels))

    def forward(self, x):
        p, k = self.precision, self.weight.shape[1]
        weight = self.weight.permute(0, 3, 2, 1)
        bias = self.bias[:, :, None]
        x = x.transpose(1, 2)
        for i, dilation in enumerate(self.dilations):
            t = p.result(F.conv1d(
                p.operand(leaky_relu(x, self.slope)),
                p.operand(weight[2 * i]), padding=(k - 1) // 2 * dilation,
                dilation=dilation)) + bias[2 * i]
            t = p.result(F.conv1d(
                p.operand(leaky_relu(t, self.slope)),
                p.operand(weight[2 * i + 1]),
                padding=(k - 1) // 2)) + bias[2 * i + 1]
            x = p.result(x + t)
        return x.transpose(1, 2)


class Stage(nn.Module):
    """Leaky ReLU → transposed upsample → average of parallel Blocks"""

    def __init__(self, in_channels, out_channels, upsample_kernel_size,
                 upsample_rate, kernel_sizes, dilation_sizes, slope,
                 precision):
        super().__init__()
        self.slope = slope
        self.upsample = ConvTranspose1d(
            in_channels, out_channels, upsample_kernel_size,
            stride=upsample_rate,
            padding=(upsample_kernel_size - upsample_rate) // 2,
            precision=precision)
        self.blocks = nn.ModuleList(
            Block(out_channels, kernel_size, dilations, slope, precision)
            for kernel_size, dilations in zip(kernel_sizes, dilation_sizes))

    def forward(self, x):
        x = self.upsample(leaky_relu(x, self.slope))
        return sum(block(x) for block in self.blocks) / len(self.blocks)


class HiFiGAN(nn.Module):
    """(B, T, num_features) features → (B, T * prod(rates), 1) audio"""

    def __init__(self, num_features, global_channels, config, precision):
        super().__init__()
        self.slope = config.LRELU_SLOPE
        channels = config.HIFIGAN_UPSAMPLE_INITIAL_SIZE
        self.input_conv = Conv1d(
            num_features, channels, 7, padding=3, precision=precision)
        self.global_conv = Conv1d(
            global_channels, channels, 1, precision=precision)
        stages = []
        for kernel_size, rate in zip(
            config.HIFIGAN_UPSAMPLE_KERNEL_SIZES, config.HIFIGAN_UPSAMPLE_RATES
        ):
            stages.append(Stage(
                channels, channels // 2, kernel_size, rate,
                config.HIFIGAN_RESBLOCK_KERNEL_SIZES,
                config.HIFIGAN_RESBLOCK_DILATION_SIZES, self.slope,
                precision))
            channels //= 2
        self.stages = nn.ModuleList(stages)
        self.output_conv = Conv1d(
            channels, 1, 7, padding=3, bias=False, precision=precision)

    def forward(self, features, global_features):
        x = self.input_conv(features) + self.global_conv(global_features)
        for stage in self.stages:
            x = stage(x)
        return torch.tanh(self.output_conv(leaky_relu(x, self.slope)))


###############################################################################
# FARGAN (models/fargan.py, inference route)
###############################################################################


class GRUCell(nn.Module):
    """The port's GRU cell: weights (3H, in) and (3H, H), gates r, z, n,
    a constant input bias of -1 / sqrt(H) and no hidden bias"""

    def __init__(self, in_features, hidden, precision):
        super().__init__()
        self.precision, self.hidden = precision, hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))

    def forward(self, state, x):
        p = self.precision
        gi = p.result(F.linear(p.operand(x), p.operand(self.weight_ih))) - \
            1. / math.sqrt(self.hidden)
        gh = p.result(F.linear(p.operand(state), p.operand(self.weight_hh)))
        i_r, i_z, i_n = gi.chunk(3, -1)
        h_r, h_z, h_n = gh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return p.result((1 - z) * n + z * state)


class GLU(nn.Module):
    def __init__(self, features, precision):
        super().__init__()
        self.dense = Dense(features, features, precision=precision)

    def forward(self, x):
        return self.dense.precision.result(x * torch.sigmoid(self.dense(x)))


class FramewiseConv(nn.Module):
    def __init__(self, in_features, features, precision):
        super().__init__()
        self.dense = Dense(2 * in_features, features, precision=precision)
        self.glu = GLU(features, precision)

    def forward(self, features, state):
        return self.glu(self.dense.precision.result(torch.tanh(self.dense(
            torch.cat((features, state), -1)))))


class ConditioningNetwork(nn.Module):
    def __init__(self, channels, hopsize, precision):
        super().__init__()
        self.layers = nn.ModuleList([
            Dense(channels, channels, precision=precision),
            Dense(channels, channels, precision=precision),
            Dense(channels, 2 * hopsize, precision=precision)])

    def forward(self, x):
        for layer in self.layers:
            x = layer.precision.result(torch.tanh(layer(x)))
        return x


class SubframeNetwork(nn.Module):
    def __init__(self, hopsize, subframe_size, precision):
        super().__init__()
        self.fwconv = FramewiseConv(4 * subframe_size + 4, hopsize, precision)
        gru_inputs = hopsize + 2 * subframe_size
        self.grus = nn.ModuleList(
            GRUCell(gru_inputs, hopsize, precision) for _ in range(3))
        self.glus = nn.ModuleList(GLU(hopsize, precision) for _ in range(3))
        self.skip = Dense(4 * hopsize + 2 * subframe_size, hopsize,
                          precision=precision)
        self.skip_glu = GLU(hopsize, precision)
        self.output = Dense(hopsize, subframe_size, precision=precision)

    def forward(self, features, pitch_lookback, previous_subframe, states):
        subframe_input = torch.cat(
            (features, previous_subframe, pitch_lookback), -1)
        fwconv_out = self.fwconv(subframe_input, states[3])
        pitch_lookback = pitch_lookback[:, 2:-2]
        gru_outs, gru_states = [], []
        gru_in = fwconv_out
        for gru, glu, state in zip(self.grus, self.glus, states):
            state = gru(state, torch.cat(
                (gru_in, pitch_lookback, previous_subframe), -1))
            gru_in = glu(state)
            gru_states.append(state)
            gru_outs.append(gru_in)
        skip = torch.cat(
            gru_outs + [fwconv_out, pitch_lookback, previous_subframe], -1)
        p = self.output.precision
        skip = self.skip_glu(p.result(torch.tanh(self.skip(skip))))
        return p.result(torch.tanh(self.output(skip))), (
            *gru_states, subframe_input)


class FARGAN(nn.Module):
    """(B, T, C) features, the last channel the pitch period in samples →
    (B, T * 256, 1) audio; hop 256, 4 subframes of 64, a history of
    `num_previous` samples starting at zero"""

    def __init__(self, num_features, global_channels, num_previous,
                 precision, hopsize=256, subframe_size=64, subframes=4):
        super().__init__()
        self.hopsize, self.subframe_size, self.subframes = (
            hopsize, subframe_size, subframes)
        self.num_previous = num_previous
        self.conditioning = ConditioningNetwork(
            num_features - 1 + global_channels, hopsize, precision)
        self.subframe = SubframeNetwork(hopsize, subframe_size, precision)

    def conditioning_of(self, features, global_features):
        """The conditioning of every subframe, (B, T, subframes,
        2 * subframe_size): subframe s of a frame takes every
        subframes-th value of the frame's output from s on"""
        batch, frames, _ = features.shape
        cond = self.conditioning(torch.cat((
            features[..., :-1], global_features.expand(batch, frames, -1)),
            -1))
        return cond.reshape(
            batch, frames, 2 * self.subframe_size, self.subframes).transpose(
                2, 3)

    def lookback_of(self, features):
        """Where each frame's pitch lookback reads in a subframe's sample
        history, (B, T, subframe_size + 4): two before one period back,
        from two periods back where one period back would run past the
        history's end"""
        size, history = self.subframe_size, self.num_previous
        period = torch.clamp(
            torch.round(features[..., -1]).long(), 1, history - size - 2)
        index = history - period[..., None] + torch.arange(
            size + 4, device=features.device) - 2
        return torch.clamp(index - period[..., None] * (index >= history),
                           0, history - 1)

    def forward(self, features, global_features):
        batch, frames, _ = features.shape
        size, history = self.subframe_size, self.num_previous
        cond = self.conditioning_of(features, global_features)
        index = self.lookback_of(features)
        device = features.device
        states = [torch.zeros((batch, self.hopsize), device=device)
                  for _ in range(3)]
        states.append(torch.zeros((batch, 4 * size + 4), device=device))
        samples = torch.zeros((batch, history + frames * self.hopsize),
                              device=device)
        for frame in range(frames):
            for subframe in range(self.subframes):
                start = (frame * self.subframes + subframe) * size
                window = samples[:, start:start + history]
                output, states = self.subframe(
                    cond[:, frame, subframe],
                    torch.gather(window, 1, index[:, frame]),
                    window[:, -size:], states)
                samples[:, start + history:start + history + size] = output
        return samples[:, history:, None]


###############################################################################
# Generator (models/generator.py)
###############################################################################


def pitch_bins(config):
    """Boundaries of the variable pitch bins where no corpus statistics
    exist: PITCH_BINS log-uniform points over [FMIN, FMAX]"""
    return np.exp(np.linspace(
        np.log(config.FMIN), np.log(config.FMAX),
        config.PITCH_BINS)).astype(np.float32)


class Generator(nn.Module):
    """Interpretable features → audio, by config.MODEL

    The configuration keys read are listed in the configuration files of
    `portbench/configs`. Pitch bins are `pitch_bins` (VARIABLE_PITCH_BINS).
    """

    def __init__(self, config, precision=EXACT):
        super().__init__()
        self.config, self.precision = config, precision
        fargan = config.MODEL == 'fargan'
        num_features = (
            config.PPG_CHANNELS + config.LOUDNESS_BANDS + 1 +
            config.PITCH_EMBEDDING_SIZE + fargan)
        global_channels = config.SPEAKER_CHANNELS + 2
        if fargan:
            self.backbone = FARGAN(
                num_features, global_channels,
                config.HOPSIZE * config.FARGAN_PREVIOUS_FRAMES, precision)
        else:
            self.backbone = HiFiGAN(
                num_features, global_channels, config, precision)
        self.speaker_embedding = nn.Embedding(
            config.NUM_SPEAKERS, config.SPEAKER_CHANNELS)
        self.pitch_embed = nn.Embedding(
            config.PITCH_BINS, config.PITCH_EMBEDDING_SIZE)
        self.register_buffer(
            'distribution', torch.from_numpy(pitch_bins(config)),
            persistent=False)

    def prepare_features(self, loudness, pitch, periodicity, ppg):
        """(B, T, NUM_FEATURES [+ 1]) from (B, F, T), (B, T), (B, T),
        (B, PPG_CHANNELS, T)"""
        config = self.config
        ppg = dsp.sparsify_percentile(ppg, config.SPARSE_PPG_THRESHOLD)
        hz = torch.clamp(pitch, config.FMIN, config.FMAX)
        bins = torch.clamp(torch.searchsorted(
            self.distribution, hz.contiguous(), right=False),
            0, config.PITCH_BINS - 1)
        loudness = (
            dsp.band_average(loudness, config.LOUDNESS_BANDS) -
            config.MIN_DB) / (config.REF_DB - config.MIN_DB)
        columns = [
            ppg.transpose(-1, -2), self.pitch_embed(bins),
            loudness.transpose(-1, -2), periodicity[..., None]]
        if config.MODEL == 'fargan':
            # The pitch period enters FARGAN as a feature of the
            # configuration's PRECISION, and is rounded to whole samples
            # from there: a stated input format, not arithmetic
            period = config.SAMPLE_RATE / hz
            if config.PRECISION == 'bfloat16':
                period = period.to(torch.bfloat16).float()
            columns.append(self.precision.operand(period)[..., None])
        return torch.cat(columns, -1)

    def inputs(self, loudness, pitch, periodicity, ppg, speakers,
               spectral_balance_ratios, loudness_ratios):
        """The backbone's (B, T, C) features and (B, 1, G) global features"""
        p = self.precision
        features = self.prepare_features(
            p.operand(loudness), p.operand(pitch), p.operand(periodicity),
            p.operand(ppg))
        global_features = torch.cat((
            self.speaker_embedding(speakers)[:, None, :],
            spectral_balance_ratios.float()[:, None, None],
            loudness_ratios.float()[:, None, None]), -1)
        return features, global_features

    def forward(self, *arguments):
        """Audio (B, 1, T * HOPSIZE); the arguments of `inputs`"""
        return self.backbone(*self.inputs(*arguments)).transpose(1, 2)
