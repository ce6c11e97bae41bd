"""Random weights seeded from numpy.

For runs without carried-over weights (the GPU smoke test, benchmarks):
the initialisation the JAX package gives a fresh model, drawn from
`numpy.random.default_rng(seed)`. Convolutions and dense layers are
uniform in ±1/sqrt(fan_in) (PyTorch's default, which the JAX package
copies; weight norm starts at g = ||v||, so the effective kernel is v),
embeddings are standard normal and LayerNorms start at (1, 0).
"""
import numpy as np
import torch
from torch import nn


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
        elif isinstance(submodule, nn.LayerNorm):
            fill(submodule.weight, np.ones(submodule.weight.shape))
            fill(submodule.bias, np.zeros(submodule.bias.shape))
        elif isinstance(submodule, nn.Linear) or hasattr(submodule, 'fan_in'):
            fan_in = getattr(submodule, 'fan_in', None) or \
                submodule.in_features
            bound = 1. / np.sqrt(fan_in)
            for parameter in (submodule.weight, submodule.bias):
                if parameter is not None:
                    fill(parameter,
                         rng.uniform(-bound, bound, parameter.shape))
    return module
