"""Random weights seeded from numpy.

For runs without carried-over weights (the GPU smoke test, benchmarks):
the initialisation the JAX package gives a fresh model, drawn from
`numpy.random.default_rng(seed)`. Convolutions and dense layers are
uniform in ±1/sqrt(fan_in) (PyTorch's default, which the JAX package
copies; weight norm starts at g = ||v||, so the effective kernel is v:
the discriminators' (v, g) pairs are drawn so),
embeddings are standard normal and LayerNorms start at (1, 0). FARGAN's
GRU kernels are uniform in [0, 2/sqrt(H)], as the JAX package draws them.
Vocos' truncated-normal and FARGAN's orthogonal kernels are drawn like
every other dense layer; Vocos' layer scales keep their constant start.
"""
import numpy as np
import torch
from torch import nn

from .fargan import GRUCellNoBias
from .modules import norm


def seeded(module, seed):
    """Fill every parameter of `module` in place; returns `module`"""
    rng = np.random.default_rng(seed)

    def fill(parameter, values):
        with torch.no_grad():
            parameter.copy_(torch.from_numpy(
                np.asarray(values, np.float32).reshape(parameter.shape)))

    for submodule in module.modules():
        if isinstance(submodule, nn.Embedding):
            fill(submodule.weight,
                 rng.standard_normal(submodule.weight.shape))
        elif isinstance(submodule, GRUCellNoBias):
            bound = 2. / np.sqrt(submodule.weight_hh.shape[1])
            for parameter in (submodule.weight_ih, submodule.weight_hh):
                fill(parameter, rng.uniform(0., bound, parameter.shape))
        elif isinstance(submodule, nn.LayerNorm):
            fill(submodule.weight, np.ones(submodule.weight.shape))
            fill(submodule.bias, np.zeros(submodule.bias.shape))
        elif hasattr(submodule, 'weight_v'):
            bound = 1. / np.sqrt(submodule.fan_in)
            fill(submodule.weight_v,
                 rng.uniform(-bound, bound, submodule.weight_v.shape))
            fill(submodule.bias,
                 rng.uniform(-bound, bound, submodule.bias.shape))
            with torch.no_grad():
                submodule.weight_g.copy_(
                    norm(submodule.weight_v, submodule.norm_axes))
        elif isinstance(submodule, nn.Linear) or hasattr(submodule, 'fan_in'):
            fan_in = getattr(submodule, 'fan_in', None) or \
                submodule.in_features
            bound = 1. / np.sqrt(fan_in)
            for parameter in (submodule.weight, submodule.bias):
                if parameter is not None:
                    fill(parameter,
                         rng.uniform(-bound, bound, parameter.shape))
    return module
