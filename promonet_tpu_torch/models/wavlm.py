"""WavLM-Base+ with an x-vector head: zero-shot speaker embeddings

Counterpart of the JAX package's first speaker path
(`promonet_tpu/preprocess/speaker.py`), which runs
`transformers.WavLMForXVector` on `microsoft/wavlm-base-plus-sv`
(WavLM: Chen et al. 2022, arXiv:2110.13900). Written from `transformers`'
`modeling_wavlm.py` without importing it. The defaults are the
published widths of `WavLMConfig()`:

- feature extractor: seven bias-free convolutions of 512 channels,
  kernels 10 3 3 3 3 2 2, strides 5 2 2 2 2 2 2, GroupNorm (one group a
  channel) on the first, GELU: 16 kHz in, 50 frames a second out;
- feature projection: LayerNorm(512), then Linear 512 -> 768;
- positional convolution: kernel 128, 16 groups, weight norm over the
  kernel axis, GELU, the last frame dropped (the kernel is even);
- encoder: LayerNorm, then 12 post-LN layers of hidden size 768, 12
  heads, FFN 3072, GELU, LayerNorm eps 1e-5;
- attention bias: T5-style bidirectional relative-position buckets (320
  buckets, max distance 800), embedded once by layer 0 and passed on,
  gated in every layer per head and query frame by
  `gate_a * (gate_b * const_h - 1) + 2`, the gates sigmoids of that
  layer's input (Linear head_dim -> 8, summed in pairs of 4);
- x-vector head: a softmax-weighted sum of the 13 hidden states, Linear
  768 -> 512, TDNN 512 512 512 512 1500 (kernels 5 3 3 1 1, dilations
  1 2 3 1 1, no padding, ReLU), mean and unbiased standard deviation
  over the frames, Linear 3000 -> 512.

Parameters keep `transformers`' names under `WavLMForXVector`'s layout
(`wavlm.encoder.layers.0.attention.q_proj.weight`, ...), float32; the
positional convolution holds its weight-norm pair as `weight_g` and
`weight_v`. `load.speaker_encoder` reads such a state dict.

Arithmetic: convolutions and matrix products in `dtype` (bfloat16 under
PRECISION 'bfloat16') with float32 accumulation; GroupNorm, LayerNorm,
the residual stream, the gates and the position bias, the weighted sum
and the pooling in float32. The gated bias joins
`scaled_dot_product_attention` as an additive mask in the products'
dtype, in its memory-efficient kernel (the plain one where that is
absent), which takes the softmax in float32. PyTorch would pick cuDNN's
attention for a float mask on the H100, which builds a graph for each new
length: every reference clip has its own, and a first call there took
0.14-1.16 s against 0.05 s (NVIDIA H100, PyTorch 2.11).

Batches of clips of different lengths (`lengths`, true samples) are
masked as `transformers` masks them: padded encoder frames are zeroed
before the positional convolution, padded keys take no attention, and
the pooling reads each clip's own frames. One departure: the first
layer's GroupNorm takes each clip's statistics over its own frames,
where `transformers` takes them over the padded length, so that a clip
in a batch gives what it gives alone.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from .modules import cast

# The published widths (transformers.WavLMConfig())
CONV_DIM = (512,) * 7
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
TDNN_DIM = (512, 512, 512, 512, 1500)
TDNN_KERNEL = (5, 3, 3, 1, 1)
TDNN_DILATION = (1, 2, 3, 1, 1)

# The rate the model reads
SAMPLE_RATE = 16000


class Linear(nn.Linear):
    """`nn.Linear` computing in `dtype`, its weight's cast kept"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._casts = {}

    def forward(self, x, dtype=torch.float32):
        bias = None if self.bias is None else cast(self, 'bias', dtype)
        return F.linear(x.to(dtype), cast(self, 'weight', dtype), bias)


class Conv1d(nn.Conv1d):
    """`nn.Conv1d` over (B, C, T) computing in `dtype`"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fan_in = self.in_channels // self.groups * self.kernel_size[0]
        self._casts = {}

    def forward(self, x, dtype=torch.float32):
        bias = None if self.bias is None else cast(self, 'bias', dtype)
        return F.conv1d(x.to(dtype), cast(self, 'weight', dtype), bias,
                        self.stride, self.padding, self.dilation, self.groups)


def conv_lengths(lengths, kernels, strides):
    """Frames after valid convolutions of `kernels` and `strides`, from
    `lengths` (an int or an integer tensor)"""
    for kernel, stride in zip(kernels, strides):
        lengths = (lengths - kernel) // stride + 1
    return lengths


def frame_mask(lengths, frames):
    """(B, frames) bool, True on each clip's own frames; None without
    lengths"""
    if lengths is None:
        return None
    return torch.arange(frames, device=lengths.device)[None] < \
        lengths[:, None]


###############################################################################
# Feature extractor and projection
###############################################################################


class ConvLayer(nn.Module):
    """A convolution of the feature extractor, with GroupNorm where it
    has one, then GELU"""

    def __init__(self, in_channels, out_channels, kernel, stride, norm):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel, stride,
                           bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(out_channels, out_channels)

    def forward(self, x, lengths, dtype):
        x = self.conv(x, dtype)
        if hasattr(self, 'layer_norm'):
            x = masked_group_norm(x.float(), self.layer_norm, lengths)
        return F.gelu(x)


def masked_group_norm(x, norm, lengths):
    """GroupNorm with one group a channel over (B, C, T), float32, each
    clip's statistics over its own `lengths` frames (all without)"""
    if lengths is None:
        return F.group_norm(x, norm.num_groups, norm.weight, norm.bias,
                            norm.eps)
    mask = frame_mask(lengths, x.shape[-1])[:, None].float()
    count = torch.clamp(lengths.float(), min=1.)[:, None, None]
    mean = (x * mask).sum(-1, keepdim=True) / count
    variance = ((x - mean) ** 2 * mask).sum(-1, keepdim=True) / count
    x = (x - mean) * torch.rsqrt(variance + norm.eps)
    return x * norm.weight[:, None] + norm.bias[:, None]


class FeatureEncoder(nn.Module):
    """Audio (B, S) -> (B, C, T) features"""

    def __init__(self, conv_dim=CONV_DIM, conv_kernel=CONV_KERNEL,
                 conv_stride=CONV_STRIDE):
        super().__init__()
        self.kernels, self.strides = tuple(conv_kernel), tuple(conv_stride)
        self.conv_layers = nn.ModuleList(
            ConvLayer(conv_dim[i - 1] if i else 1, conv_dim[i],
                      conv_kernel[i], conv_stride[i], norm=i == 0)
            for i in range(len(conv_dim)))

    def forward(self, audio, lengths=None, dtype=torch.float32):
        """lengths: (B,) true samples, or None for clips of one length"""
        x = audio[:, None]
        first = None if lengths is None else conv_lengths(
            lengths, self.kernels[:1], self.strides[:1])
        for layer in self.conv_layers:
            x = layer(x, first, dtype)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, in_channels=CONV_DIM[-1], hidden_size=768, eps=1e-5):
        super().__init__()
        self.layer_norm = nn.LayerNorm(in_channels, eps=eps)
        self.projection = Linear(in_channels, hidden_size)

    def forward(self, x, dtype=torch.float32):
        """(B, T, C) -> (B, T, hidden) float32"""
        return self.projection(self.layer_norm(x.float()), dtype).float()


###############################################################################
# Encoder
###############################################################################


class PositionalConv(nn.Module):
    """Grouped, weight-normed convolution over (B, T, H): the relative
    positional embedding added to the encoder's input

    weight = weight_g * weight_v / ||weight_v||, the norm over the
    output and input axes (PyTorch's weight_norm with dim=2), kept
    between calls while the pair is unchanged."""

    def __init__(self, hidden_size=768, kernel=128, groups=16):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.norm_axes = (0, 1)
        self.fan_in = hidden_size // groups * kernel
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(hidden_size, hidden_size // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(hidden_size))
        self._casts = {}

    def weight(self, dtype):
        g, v = self.weight_g, self.weight_v
        if torch.is_grad_enabled() and (g.requires_grad or v.requires_grad):
            return (g * v / torch.linalg.vector_norm(
                v, dim=self.norm_axes, keepdim=True)).to(dtype)
        key = (dtype, v.device, g.data_ptr(), g._version, v.data_ptr(),
               v._version)
        if self._casts.get('weight', (None,))[0] != key:
            with torch.no_grad():
                weight = g * v / torch.linalg.vector_norm(
                    v, dim=self.norm_axes, keepdim=True)
            self._casts['weight'] = (key, weight.to(dtype))
        return self._casts['weight'][1]

    def forward(self, x, dtype=torch.float32):
        y = F.conv1d(x.transpose(1, 2).to(dtype), self.weight(dtype),
                     cast(self, 'bias', dtype), padding=self.kernel // 2,
                     groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


def relative_buckets(relative, num_buckets=320, max_distance=800):
    """T5's bidirectional buckets of integer relative positions (key
    minus query), as `transformers` computes them (float32 logarithm)"""
    half = num_buckets // 2
    buckets = (relative > 0).long() * half
    relative = torch.abs(relative)
    exact = half // 2
    large = (exact + torch.log(relative.float() / exact) /
             math.log(max_distance / exact) * (half - exact)).long()
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(relative < exact, relative, large)


class Attention(nn.Module):
    """Self-attention with the gated relative position bias"""

    def __init__(self, hidden_size=768, num_heads=12, num_buckets=320,
                 max_distance=800, position_embedding=False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.q_proj = Linear(hidden_size, hidden_size)
        self.k_proj = Linear(hidden_size, hidden_size)
        self.v_proj = Linear(hidden_size, hidden_size)
        self.out_proj = Linear(hidden_size, hidden_size)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, num_heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        if position_embedding:
            self.rel_attn_embed = nn.Embedding(num_buckets, num_heads)
        self._casts = {}

    def position_bias(self, frames, device):
        """(heads, T, T) float32 bias of the relative positions; only the
        layer that holds the embedding makes it"""
        positions = torch.arange(frames, device=device)
        # Each relative position's bucket once, then laid out T x T
        buckets = relative_buckets(
            torch.arange(-(frames - 1), frames, device=device),
            self.num_buckets, self.max_distance)
        values = self.rel_attn_embed(buckets).float().T
        return values[:, positions[None, :] - positions[:, None] + frames - 1]

    def qkv(self, dtype):
        """The three projections' weights and biases stacked, in `dtype`,
        kept while they are unchanged"""
        projections = (self.q_proj, self.k_proj, self.v_proj)
        key = (dtype,) + tuple(
            (p.device, p.data_ptr(), p._version)
            for projection in projections
            for p in (projection.weight, projection.bias))
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            return (torch.cat([p.weight for p in projections]).to(dtype),
                    torch.cat([p.bias for p in projections]).to(dtype))
        if self._casts.get('qkv', (None,))[0] != key:
            with torch.no_grad():
                self._casts['qkv'] = (key, (
                    torch.cat([p.weight for p in projections]).to(dtype),
                    torch.cat([p.bias for p in projections]).to(dtype)))
        return self._casts['qkv'][1]

    def forward(self, x, position_bias, key_mask=None, dtype=torch.float32):
        """x (B, T, H) float32, position_bias (heads, T, T) float32,
        key_mask (B, T) bool (True: a frame of the clip) or None; returns
        (B, T, H) in `dtype`"""
        batch, frames, _ = x.shape
        heads, width = self.num_heads, self.head_dim
        # The gates, per head and query frame, from the layer's input
        gates = self.gru_rel_pos_linear(
            x.view(batch, frames, heads, width).transpose(1, 2))
        gates = torch.sigmoid(gates.view(batch, heads, frames, 2, 4).sum(-1))
        gate = gates[..., :1] * (
            gates[..., 1:] * self.gru_rel_pos_const - 1.) + 2.
        bias = gate * position_bias
        if key_mask is not None:
            bias = bias.masked_fill(~key_mask[:, None, None], -math.inf)
        weight, stacked_bias = self.qkv(dtype)
        q, k, v = F.linear(x.to(dtype), weight, stacked_bias).view(
            batch, frames, 3, heads, width).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(dtype))
        return self.out_proj(
            y.transpose(1, 2).reshape(batch, frames, heads * width), dtype)


class FeedForward(nn.Module):
    def __init__(self, hidden_size=768, intermediate_size=3072):
        super().__init__()
        self.intermediate_dense = Linear(hidden_size, intermediate_size)
        self.output_dense = Linear(intermediate_size, hidden_size)

    def forward(self, x, dtype=torch.float32):
        return self.output_dense(
            F.gelu(self.intermediate_dense(x, dtype)), dtype)


class EncoderLayer(nn.Module):
    """Post-LN: LayerNorm(x + attention(x)), then LayerNorm(h + FFN(h))"""

    def __init__(self, hidden_size=768, num_heads=12, intermediate_size=3072,
                 num_buckets=320, max_distance=800, eps=1e-5,
                 position_embedding=False):
        super().__init__()
        self.attention = Attention(hidden_size, num_heads, num_buckets,
                                   max_distance, position_embedding)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=eps)
        self.feed_forward = FeedForward(hidden_size, intermediate_size)
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=eps)

    def forward(self, x, position_bias, key_mask=None, dtype=torch.float32):
        x = self.layer_norm(
            x + self.attention(x, position_bias, key_mask, dtype).float())
        return self.final_layer_norm(
            x + self.feed_forward(x, dtype).float())


class Encoder(nn.Module):
    def __init__(self, hidden_size=768, num_layers=12, num_heads=12,
                 intermediate_size=3072, pos_kernel=128, pos_groups=16,
                 num_buckets=320, max_distance=800, eps=1e-5):
        super().__init__()
        self.pos_conv_embed = nn.Module()
        self.pos_conv_embed.conv = PositionalConv(
            hidden_size, pos_kernel, pos_groups)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=eps)
        self.layers = nn.ModuleList(
            EncoderLayer(hidden_size, num_heads, intermediate_size,
                         num_buckets, max_distance, eps,
                         position_embedding=i == 0)
            for i in range(num_layers))

    def forward(self, x, key_mask=None, dtype=torch.float32):
        """x (B, T, H) float32 -> the 13 hidden states, float32"""
        if key_mask is not None:
            x = x * key_mask[..., None]
        x = self.layer_norm(x + self.pos_conv_embed.conv(x, dtype).float())
        states = [x]
        bias = self.layers[0].attention.position_bias(x.shape[1], x.device)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            for layer in self.layers:
                x = layer(x, bias, key_mask, dtype)
                states.append(x)
        return states


class WavLM(nn.Module):
    """The feature extractor, projection and encoder"""

    def __init__(self, conv_dim=CONV_DIM, conv_kernel=CONV_KERNEL,
                 conv_stride=CONV_STRIDE, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, pos_kernel=128,
                 pos_groups=16, num_buckets=320, max_distance=800,
                 eps=1e-5):
        super().__init__()
        self.feature_extractor = FeatureEncoder(
            conv_dim, conv_kernel, conv_stride)
        self.feature_projection = FeatureProjection(
            conv_dim[-1], hidden_size, eps)
        self.encoder = Encoder(
            hidden_size, num_layers, num_heads, intermediate_size,
            pos_kernel, pos_groups, num_buckets, max_distance, eps)


class TDNNLayer(nn.Module):
    """A dilated valid convolution held as `transformers`' Linear over
    (kernel x in) inputs, then ReLU"""

    def __init__(self, in_channels, out_channels, kernel, dilation):
        super().__init__()
        self.kernel_size, self.dilation = kernel, dilation
        self.kernel = nn.Linear(in_channels * kernel, out_channels)
        self._casts = {}

    def weight(self, dtype):
        """The Linear's weight as a (out, in, kernel) convolution kernel"""
        weight = self.kernel.weight
        key = (dtype, weight.device, weight.data_ptr(), weight._version)
        if self._casts.get('weight', (None,))[0] != key:
            with torch.no_grad():
                self._casts['weight'] = (key, weight.view(
                    weight.shape[0], self.kernel_size, -1).transpose(
                        1, 2).to(dtype).contiguous())
        return self._casts['weight'][1]

    def forward(self, x, dtype=torch.float32):
        """(B, C, T) -> (B, C', T - dilation * (kernel - 1))"""
        return F.relu(F.conv1d(
            x.to(dtype), self.weight(dtype), self.kernel.bias.to(dtype),
            dilation=self.dilation))


class WavLMXVector(nn.Module):
    """WavLM and its x-vector head: 16 kHz audio (B, S) -> (B, 512)

    dtype: the products' and convolutions' dtype (PRECISION);
    `from_config` keys read: `transformers.WavLMConfig`'s."""

    def __init__(self, conv_dim=CONV_DIM, conv_kernel=CONV_KERNEL,
                 conv_stride=CONV_STRIDE, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, pos_kernel=128,
                 pos_groups=16, num_buckets=320, max_distance=800,
                 eps=1e-5, tdnn_dim=TDNN_DIM, tdnn_kernel=TDNN_KERNEL,
                 tdnn_dilation=TDNN_DILATION, xvector_dim=512,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.wavlm = WavLM(
            conv_dim, conv_kernel, conv_stride, hidden_size, num_layers,
            num_heads, intermediate_size, pos_kernel, pos_groups,
            num_buckets, max_distance, eps)
        self.layer_weights = nn.Parameter(
            torch.ones(num_layers + 1) / (num_layers + 1))
        self.projector = Linear(hidden_size, tdnn_dim[0])
        self.tdnn = nn.ModuleList(
            TDNNLayer(tdnn_dim[i - 1] if i else tdnn_dim[0], tdnn_dim[i],
                      tdnn_kernel[i], tdnn_dilation[i])
            for i in range(len(tdnn_dim)))
        self.feature_extractor = Linear(2 * tdnn_dim[-1], xvector_dim)

    @classmethod
    def from_config(cls, values, dtype=torch.bfloat16):
        """The model of a `transformers` WavLM configuration (a dict of
        `config.json`'s keys; absent keys take the published values).
        Only the post-LN, group-norm layout of WavLM-Base+ with a weighted
        layer sum is ported."""
        get = values.get
        if get('do_stable_layer_norm', False) or \
                get('feat_extract_norm', 'group') != 'group' or \
                get('conv_bias', False) or \
                not get('use_weighted_layer_sum', True):
            raise NotImplementedError(
                'only the post-LN, group-norm WavLM with a weighted layer '
                'sum (WavLM-Base+) is ported')
        return cls(
            tuple(get('conv_dim', CONV_DIM)),
            tuple(get('conv_kernel', CONV_KERNEL)),
            tuple(get('conv_stride', CONV_STRIDE)),
            get('hidden_size', 768), get('num_hidden_layers', 12),
            get('num_attention_heads', 12), get('intermediate_size', 3072),
            get('num_conv_pos_embeddings', 128),
            get('num_conv_pos_embedding_groups', 16),
            get('num_buckets', 320), get('max_bucket_distance', 800),
            get('layer_norm_eps', 1e-5), tuple(get('tdnn_dim', TDNN_DIM)),
            tuple(get('tdnn_kernel', TDNN_KERNEL)),
            tuple(get('tdnn_dilation', TDNN_DILATION)),
            get('xvector_output_dim', 512), dtype)

    @property
    def receptive(self):
        """Frames the TDNN takes from each clip's frames"""
        return sum(layer.dilation * (layer.kernel_size - 1)
                   for layer in self.tdnn)

    def frames(self, samples):
        """Encoder frames of `samples` samples (an int or a tensor)"""
        extractor = self.wavlm.feature_extractor
        return conv_lengths(samples, extractor.kernels, extractor.strides)

    def features(self, audio, lengths=None):
        """Audio (B, S) -> projected features (B, T, hidden), float32"""
        if self.frames(audio.shape[-1]) - self.receptive < 2:
            raise ValueError(
                f'{audio.shape[-1]} samples give too few frames for the '
                'x-vector head\'s statistics')
        x = self.wavlm.feature_extractor(audio.float(), lengths, self.dtype)
        return self.wavlm.feature_projection(x.transpose(1, 2), self.dtype)

    def encode(self, features, lengths=None):
        """Projected features -> the 13 hidden states (B, T, hidden)"""
        mask = None if lengths is None else frame_mask(
            self.frames(lengths), features.shape[1])
        return self.wavlm.encoder(features, mask, self.dtype)

    def statistics(self, states, lengths=None):
        """The 13 hidden states -> the pooled (B, 2 x TDNN width) mean and
        unbiased standard deviation over each clip's frames, float32"""
        weights = torch.softmax(self.layer_weights.float(), -1)
        x = torch.einsum('l,lbth->bth', weights, torch.stack(states))
        x = self.projector(x, self.dtype).transpose(1, 2)
        for layer in self.tdnn:
            x = layer(x, self.dtype)
        x = x.float()
        if lengths is None:
            return torch.cat([x.mean(-1), x.std(-1)], -1)
        valid = self.frames(lengths) - self.receptive
        mask = frame_mask(valid, x.shape[-1])[:, None].float()
        count = valid.float()[:, None]
        mean = (x * mask).sum(-1) / count
        variance = ((x - mean[..., None]) ** 2 * mask).sum(-1) / (count - 1)
        return torch.cat([mean, torch.sqrt(variance)], -1)

    def xvector(self, states, lengths=None):
        """The 13 hidden states -> (B, 512) x-vectors, float32"""
        return self.feature_extractor(
            self.statistics(states, lengths), self.dtype).float()

    def forward(self, audio, lengths=None):
        """Audio (B, S) at 16 kHz and its true samples (B,) (None: every
        clip whole) -> (B, 512) x-vectors before normalisation"""
        return self.xvector(
            self.encode(self.features(audio, lengths), lengths), lengths)
