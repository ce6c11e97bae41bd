"""The plain reference of WavLM-Base+ with its x-vector head, and of the
zero-shot generator's speaker conditioning

Written from the published description of `microsoft/wavlm-base-plus-sv`
(WavLM: Chen et al. 2022, arXiv:2110.13900; `transformers.WavLMConfig()`
and `WavLMForXVector`), in plain PyTorch: float32 with TF32 off
(`precision.exact`), or with every convolution's and product's operands
and results in scaled float8 (`precision.Float8`), the control. It
imports neither JAX nor the port. One clip at a time, no cache, and
attention written out over the full T x T:
softmax(Q K^T / sqrt(d) + gated bias) V for each head.

Parameters take `transformers`' names under `WavLMForXVector`'s layout,
so the harness's state dict loads into the program and into this alike;
the positional convolution's weight-norm pair is `weight_g`, `weight_v`.

Departures from the description, each a choice of form, not of result:
- the relative-position buckets are computed with a float32 logarithm,
  as `transformers` computes them (the description gives the formula,
  not the arithmetic);
- the TDNN's kernels are held as `transformers` holds them, a Linear
  over (kernel x in) inputs, and applied as a convolution of the
  reshaped weight;
- the pooling's standard deviation is the unbiased one, as
  `WavLMForXVector` takes it (`torch.std`).
"""
import math

import torch
from torch import nn

from . import models
from .precision import EXACT

# The published widths
CONV_DIM = (512,) * 7
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
TDNN_DIM = (512, 512, 512, 512, 1500)
TDNN_KERNEL = (5, 3, 3, 1, 1)
TDNN_DILATION = (1, 2, 3, 1, 1)
SIZES = dict(
    conv_dim=CONV_DIM, conv_kernel=CONV_KERNEL, conv_stride=CONV_STRIDE,
    hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
    pos_kernel=128, pos_groups=16, num_buckets=320, max_distance=800,
    eps=1e-5, tdnn_dim=TDNN_DIM, tdnn_kernel=TDNN_KERNEL,
    tdnn_dilation=TDNN_DILATION, xvector_dim=512)


def gelu(x):
    """GELU with the error function"""
    return 0.5 * x * (1. + torch.erf(x / math.sqrt(2.)))


def layer_norm(x, weight, bias, eps):
    """Over the last axis"""
    mean = x.mean(-1, keepdim=True)
    variance = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(variance + eps) * weight + bias


def buckets(query, key, num_buckets, max_distance):
    """T5's bidirectional bucket of each relative position key - query"""
    relative = key[None, :] - query[:, None]
    half = num_buckets // 2
    exact = half // 2
    out = (relative > 0).long() * half
    distance = relative.abs()
    large = (exact + torch.log(distance.float() / exact) /
             math.log(max_distance / exact) * (half - exact)).long()
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return out + torch.where(distance < exact, distance, large)


class Linear(nn.Linear):
    """y = x W^T + b, operands and result through the precision"""

    def __init__(self, *args, precision=EXACT, **kwargs):
        super().__init__(*args, **kwargs)
        self.precision = precision

    def forward(self, x):
        p = self.precision
        y = p.operand(x) @ p.operand(self.weight).T
        return p.result(y + self.bias if self.bias is not None else y)


def conv1d(x, weight, bias, precision, stride=1, dilation=1, padding=0,
           groups=1):
    """A convolution of (C, T), operands and result through the precision"""
    p = precision
    y = torch.nn.functional.conv1d(
        p.operand(x)[None], p.operand(weight), None, stride, padding,
        dilation, groups)[0]
    if bias is not None:
        y = y + bias[:, None]
    return p.result(y)


class Holder(nn.Module):
    """A module that only holds named parameters"""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


def _conv(in_channels, out_channels, kernel, bias=True, groups=1):
    conv = Holder(weight=(out_channels, in_channels // groups, kernel))
    if bias:
        conv.bias = nn.Parameter(torch.zeros(out_channels))
    return conv


def _norm(channels):
    return Holder(weight=(channels,), bias=(channels,))


class WavLMXVector(nn.Module):
    """16 kHz audio (S,) -> the intermediates and the x-vector (512,)"""

    def __init__(self, precision=EXACT, **sizes):
        super().__init__()
        s = dict(SIZES, **sizes)
        self.s, self.precision = s, precision
        p = precision
        hidden, heads = s['hidden_size'], s['num_heads']
        self.wavlm = nn.Module()
        extractor = self.wavlm.feature_extractor = nn.Module()
        extractor.conv_layers = nn.ModuleList()
        for i, (channels, kernel) in enumerate(zip(s['conv_dim'],
                                                   s['conv_kernel'])):
            layer = nn.Module()
            layer.conv = _conv(s['conv_dim'][i - 1] if i else 1, channels,
                               kernel, bias=False)
            if i == 0:
                layer.layer_norm = _norm(channels)
            extractor.conv_layers.append(layer)
        projection = self.wavlm.feature_projection = nn.Module()
        projection.layer_norm = _norm(s['conv_dim'][-1])
        projection.projection = Linear(s['conv_dim'][-1], hidden,
                                       precision=p)
        encoder = self.wavlm.encoder = nn.Module()
        encoder.pos_conv_embed = nn.Module()
        encoder.pos_conv_embed.conv = Holder(
            weight_g=(1, 1, s['pos_kernel']),
            weight_v=(hidden, hidden // s['pos_groups'], s['pos_kernel']),
            bias=(hidden,))
        encoder.layer_norm = _norm(hidden)
        encoder.layers = nn.ModuleList()
        for i in range(s['num_layers']):
            layer = nn.Module()
            attention = layer.attention = nn.Module()
            for name in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
                setattr(attention, name, Linear(hidden, hidden, precision=p))
            attention.gru_rel_pos_const = nn.Parameter(
                torch.ones(1, heads, 1, 1))
            attention.gru_rel_pos_linear = Linear(hidden // heads, 8,
                                                  precision=p)
            if i == 0:
                attention.rel_attn_embed = nn.Embedding(
                    s['num_buckets'], heads)
            layer.layer_norm = _norm(hidden)
            layer.feed_forward = nn.Module()
            layer.feed_forward.intermediate_dense = Linear(
                hidden, s['intermediate_size'], precision=p)
            layer.feed_forward.output_dense = Linear(
                s['intermediate_size'], hidden, precision=p)
            layer.final_layer_norm = _norm(hidden)
            encoder.layers.append(layer)
        self.layer_weights = nn.Parameter(torch.zeros(s['num_layers'] + 1))
        self.projector = Linear(hidden, s['tdnn_dim'][0], precision=p)
        self.tdnn = nn.ModuleList()
        for i, (channels, kernel) in enumerate(zip(s['tdnn_dim'],
                                                   s['tdnn_kernel'])):
            layer = nn.Module()
            layer.kernel = nn.Linear(
                (s['tdnn_dim'][i - 1] if i else s['tdnn_dim'][0]) * kernel,
                channels)
            self.tdnn.append(layer)
        self.feature_extractor = Linear(2 * s['tdnn_dim'][-1],
                                        s['xvector_dim'], precision=p)

    def forward(self, audio):
        """{'features': (T, hidden) projected features, 'states': the 13
        hidden states (T, hidden), 'statistics': (2 x 1500,) pooled mean
        and standard deviation, 'xvector': (512,)}"""
        s, p, w = self.s, self.precision, self.wavlm
        x = p.operand(audio.float())[None]
        for i, layer in enumerate(w.feature_extractor.conv_layers):
            x = conv1d(x, layer.conv.weight, None, p,
                       stride=s['conv_stride'][i])
            if i == 0:
                # GroupNorm, one group a channel: over time, per channel
                mean = x.mean(-1, keepdim=True)
                variance = ((x - mean) ** 2).mean(-1, keepdim=True)
                x = (x - mean) / torch.sqrt(variance + 1e-5) * \
                    layer.layer_norm.weight[:, None] + \
                    layer.layer_norm.bias[:, None]
            x = gelu(x)
        x = x.T
        norm = w.feature_projection.layer_norm
        features = w.feature_projection.projection(
            layer_norm(x, norm.weight, norm.bias, s['eps']))
        encoder = w.encoder
        conv = encoder.pos_conv_embed.conv
        weight = conv.weight_g * conv.weight_v / torch.sqrt(
            (conv.weight_v ** 2).sum((0, 1), keepdim=True))
        position = conv1d(features.T, weight, conv.bias, p,
                          padding=s['pos_kernel'] // 2,
                          groups=s['pos_groups'])
        if s['pos_kernel'] % 2 == 0:
            position = position[:, :-1]
        x = features + gelu(position).T
        x = layer_norm(x, encoder.layer_norm.weight, encoder.layer_norm.bias,
                       s['eps'])
        frames = x.shape[0]
        positions = torch.arange(frames, device=x.device)
        bias = encoder.layers[0].attention.rel_attn_embed(buckets(
            positions, positions, s['num_buckets'], s['max_distance']))
        bias = bias.permute(2, 0, 1)            # (heads, T query, T key)
        states = [x]
        for layer in encoder.layers:
            x = self.layer(layer, x, bias)
            states.append(x)
        weights = torch.softmax(self.layer_weights, -1)
        x = sum(weight * state for weight, state in zip(weights, states))
        x = self.projector(x).T
        for i, layer in enumerate(self.tdnn):
            kernel = s['tdnn_kernel'][i]
            weight = layer.kernel.weight.view(
                layer.kernel.weight.shape[0], kernel, -1).transpose(1, 2)
            x = torch.relu(conv1d(x, weight, layer.kernel.bias, p,
                                  dilation=s['tdnn_dilation'][i]))
        statistics = torch.cat([x.mean(-1), x.std(-1)])
        return {'features': features, 'states': states,
                'statistics': statistics,
                'xvector': self.feature_extractor(statistics)}

    def layer(self, layer, x, bias):
        """One post-LN layer: attention with the gated bias, then FFN"""
        s, p = self.s, self.precision
        heads = s['num_heads']
        width = s['hidden_size'] // heads
        attention = layer.attention
        frames = x.shape[0]
        # Gates per head and query frame from the layer's input
        per_head = x.view(frames, heads, width).transpose(0, 1)
        projected = attention.gru_rel_pos_linear(per_head)
        projected = projected.view(heads, frames, 2, 4).sum(-1)
        gate_a = torch.sigmoid(projected[..., 0])
        gate_b = torch.sigmoid(projected[..., 1])
        const = attention.gru_rel_pos_const.view(heads, 1)
        gate = gate_a * (gate_b * const - 1.) + 2.       # (heads, T)
        gated = gate[..., None] * bias
        q = attention.q_proj(x).view(frames, heads, width).transpose(0, 1)
        k = attention.k_proj(x).view(frames, heads, width).transpose(0, 1)
        v = attention.v_proj(x).view(frames, heads, width).transpose(0, 1)
        scores = p.result(p.operand(q) @ p.operand(k).transpose(1, 2))
        probabilities = torch.softmax(scores / math.sqrt(width) + gated, -1)
        y = p.result(p.operand(probabilities) @ p.operand(v))
        y = attention.out_proj(y.transpose(0, 1).reshape(frames, -1))
        x = layer_norm(x + y, layer.layer_norm.weight, layer.layer_norm.bias,
                       s['eps'])
        forward = layer.feed_forward
        h = forward.output_dense(gelu(forward.intermediate_dense(x)))
        return layer_norm(x + h, layer.final_layer_norm.weight,
                          layer.final_layer_norm.bias, s['eps'])


class ZeroShotGenerator(models.Generator):
    """The reference generator under ZERO_SHOT: the speaker enters as an
    x-vector (B, 512) through a dense layer (512 -> SPEAKER_CHANNELS,
    with bias) in the speaker table's place"""

    def __init__(self, config, precision=EXACT):
        super().__init__(config, precision)
        self.speaker_embedding = Linear(
            config.WAVLM_EMBEDDING_CHANNELS, config.SPEAKER_CHANNELS,
            precision=precision)


class Bound(nn.Module):
    """A zero-shot generator called as the chain calls a generator with a
    speaker index: the index is ignored and `xvector` (512,) given"""

    def __init__(self, generator, xvector):
        super().__init__()
        self.generator, self.xvector = generator, xvector

    def forward(self, loudness, pitch, periodicity, ppg, speakers, *ratios):
        return self.generator(
            loudness, pitch, periodicity, ppg,
            self.xvector.float()[None].to(pitch.device), *ratios)
