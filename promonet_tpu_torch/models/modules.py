"""Convolution building blocks (counterpart of `models/modules.py`)

Activations are (B, T, C), as in the JAX package. Weights are stored
in PyTorch's layouts and hold the EFFECTIVE kernel: there are no
weight-norm hooks at run time. Each module records `fan_in`, the fan-in
of PyTorch's default (and the JAX package's) uniform initialisation, for
`models/init.py`, and a weight-normed one the axes of its norm,
`norm_axes`.

Weight norm is trained as the JAX package trains it: the trainable set
holds (v, g) for every weight-normed weight (`split`), and each step
materialises v * (g / sqrt(sum(v^2) + 1e-12)) over `norm_axes`
(`materialize`) into a state dict that the module is called with
(`torch.func.functional_call`). Inference loads that state dict, so the
kernels serve trained weights unchanged.

Parameters stay float32; a forward pass casts them to its compute dtype,
accumulates in float32 inside the convolution, rounds to the compute
dtype, and adds the bias in that dtype, as `conv1d_shifted_dots` does.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resblock import leaky_relu  # noqa: F401  (re-exported)


class Conv1d(nn.Module):
    """1-D convolution over (B, T, C)

    `padding` is an int (both sides) or a (left, right) pair. Weight is
    (out, in // groups, k), PyTorch's layout.
    """

    def __init__(
        self, in_channels, out_channels, kernel_size, stride=1, padding=0,
        bias=True, groups=1, dilation=1
    ):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.dilation = dilation
        self.padding = (
            (padding, padding) if isinstance(padding, int) else
            tuple(padding))
        self.fan_in = in_channels // groups * kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x, dtype=torch.float32):
        x = x.transpose(1, 2).to(dtype)
        if any(self.padding):
            x = F.pad(x, self.padding)
        y = F.conv1d(
            x, self.weight.to(dtype), stride=self.stride,
            dilation=self.dilation, groups=self.groups).transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution over (B, T, C)

    Output length (T - 1) * stride - 2 * padding + kernel_size. Weight is
    (in, out, k), PyTorch's layout: the JAX package's unflipped
    lhs-dilated (k, in, out) kernel flipped along k.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding):
        super().__init__()
        # Weight-normed per INPUT channel, over (out, k), as PyTorch's
        # weight_norm(dim=0) and the JAX package do for transposed convs
        self.norm_axes = (1, 2)
        self.stride = stride
        self.padding = padding
        self.fan_in = in_channels * kernel_size
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x, dtype=torch.float32):
        y = F.conv_transpose1d(
            x.transpose(1, 2).to(dtype), self.weight.to(dtype),
            stride=self.stride, padding=self.padding).transpose(1, 2)
        return y + self.bias.to(dtype)


class Dense(nn.Module):
    """Dense layer over (..., in) with weight (out, in), PyTorch's layout

    Also the counterpart of the JAX package's weight-normed `WNDense`:
    the bridge materialises the norm into the weight.

    Computes in `dtype` with float32 accumulation, rounds, then adds the
    bias in `dtype`, as Flax's `nn.Dense(dtype=...)` does. The weight's
    cast to `dtype` is kept between calls while the weight is unchanged
    and needs no gradient: the FARGAN recurrence calls each layer four
    times per frame.
    """

    def __init__(self, in_features, out_features, bias=False,
                 weight_norm=False):
        super().__init__()
        # Per output, over the inputs
        self.norm_axes = (1,) if weight_norm else None
        self.fan_in = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._casts = {}

    def forward(self, x, dtype=torch.float32):
        y = F.linear(x.to(dtype), cast(self, 'weight', dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


###############################################################################
# Weight norm
###############################################################################


def weight_norm(v, g, axes):
    """The effective weight v * (g / sqrt(sum(v^2 over axes) + 1e-12)),
    in the JAX package's order of operations"""
    return v * (g / norm(v, axes))


def norm(weight, axes):
    """sqrt(sum(weight^2 over axes) + 1e-12), keeping the reduced axes"""
    return torch.sqrt(
        torch.sum(torch.square(weight), dim=axes, keepdim=True) + 1e-12)


def normed(module):
    """{parameter name: norm axes} of every weight-normed weight of module"""
    return {
        f'{prefix}.weight' if prefix else 'weight': submodule.norm_axes
        for prefix, submodule in module.named_modules()
        if getattr(submodule, 'norm_axes', None)}


def split(state, axes_by_name):
    """The trainable set of an effective state dict

    Each weight-normed weight `name` becomes `name_v` = the weight and
    `name_g` = its norm (`norm`), so that `materialize` gives the weight
    back (to float32 rounding); this is how the JAX package initialises g,
    and how a checkpoint of effective weights warm-starts. Every other
    entry is kept as it is.
    """
    trainable = {}
    for name, value in state.items():
        if name in axes_by_name:
            trainable[f'{name}_v'] = value
            trainable[f'{name}_g'] = norm(value, axes_by_name[name])
        else:
            trainable[name] = value
    return trainable


def materialize(trainable, axes_by_name):
    """The effective state dict of a trainable set (see `split`)"""
    state = {}
    for name, value in trainable.items():
        if name.endswith('_g') and name[:-2] in axes_by_name:
            continue
        if name.endswith('_v') and name[:-2] in axes_by_name:
            name = name[:-2]
            value = weight_norm(
                value, trainable[f'{name}_g'], axes_by_name[name])
        state[name] = value
    return state


def cast(module, name, dtype):
    """Parameter or buffer `name` of `module` in `dtype`, cast once and kept

    The casts live in `module._casts`. One is made anew when the
    parameter was written to or moved; a parameter that needs a gradient
    is cast on every call.
    """
    parameter = getattr(module, name)
    if parameter.dtype == dtype:
        return parameter
    if parameter.requires_grad and torch.is_grad_enabled():
        return parameter.to(dtype)
    key = (dtype, parameter.device, parameter.data_ptr(), parameter._version)
    if module._casts.get(name, (None,))[0] != key:
        module._casts[name] = (key, parameter.detach().to(dtype))
    return module._casts[name][1]


def same_padding(length, kernel_size, stride):
    """(left, right) padding of Flax's 'SAME' convolutions

    Flax pads so that the output has ceil(length / stride) frames and
    puts the smaller half on the left; with an even kernel that half is
    smaller than PyTorch's symmetric `padding='same'`.
    """
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


def get_padding(kernel_size, dilation=1, stride=1):
    """Padding that keeps a convolution's length ('same' at stride 1)"""
    return int((kernel_size * dilation - dilation - stride + 1) / 2)
