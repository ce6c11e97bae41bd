"""Weights from the seed, made on the device in two calls

The law is the one a fresh model of the port starts from
(`promonet_tpu_torch/models/init.py`): convolutions and dense layers
uniform in ±1/sqrt(fan_in), GRU kernels uniform in [0, 2/sqrt(H)],
embeddings standard normal, LayerNorms at (1, 0), and a weight-normed
convolution's g at the norm of its v, so that its weight is v; a
configuration may widen the generator's weights (`gain`). All uniform
draws of a model come from one `torch.rand` call and all normal draws
from one `torch.randn` call of a `torch.Generator` on the device, in
float32, the type the port keeps its parameters in. The result is a
state dict that the harness loads into the program and hands to the
reference.
"""
import math

import torch
from torch import nn


def _rule(module, name, parameter, gain):
    """('uniform', low, high), ('normal',) or ('constant', value); the
    bound of a convolution's or dense layer's weight times `gain`"""
    if isinstance(module, nn.Embedding):
        return ('normal',)
    if isinstance(module, nn.LayerNorm):
        return ('constant', 1. if name == 'weight' else 0.)
    if name == 'weight_g':
        return ('norm', module.norm_axes)
    if name in ('weight_ih', 'weight_hh'):
        return ('uniform', 0., 2. / math.sqrt(module.weight_hh.shape[1]))
    fan_in = getattr(module, 'fan_in', None)
    if fan_in is None and isinstance(module, nn.Linear):
        fan_in = module.in_features
    if fan_in is None:
        raise ValueError(
            f'No initialisation law for {type(module).__name__}.{name}')
    bound = (gain if name == 'weight' else 1.) / math.sqrt(fan_in)
    return ('uniform', -bound, bound)


def seeded_state(model, seed, device, gain=1.):
    """{parameter name: float32 tensor on `device`} for every parameter of
    `model`, drawn from `seed`; `gain` widens the weights' bound"""
    entries = []
    for prefix, module in model.named_modules():
        for name, parameter in module.named_parameters(recurse=False):
            full = f'{prefix}.{name}' if prefix else name
            entries.append((full, parameter.shape, _rule(
                module, name, parameter, gain)))
    generator = torch.Generator(device=device).manual_seed(seed)
    counts = {kind: sum(math.prod(shape) for _, shape, rule in entries
                        if rule[0] == kind)
              for kind in ('uniform', 'normal')}
    draws = {
        'uniform': torch.rand(counts['uniform'], generator=generator,
                              device=device),
        'normal': torch.randn(counts['normal'], generator=generator,
                              device=device)}
    offsets = {'uniform': 0, 'normal': 0}
    state = {}
    for name, shape, rule in entries:
        size = math.prod(shape)
        if rule[0] == 'constant':
            state[name] = torch.full(shape, rule[1], device=device)
            continue
        if rule[0] == 'norm':
            continue
        values = draws[rule[0]][offsets[rule[0]]:offsets[rule[0]] + size]
        offsets[rule[0]] += size
        if rule[0] == 'uniform':
            values = rule[1] + (rule[2] - rule[1]) * values
        state[name] = values.reshape(shape)
    for name, shape, rule in entries:
        if rule[0] == 'norm':
            state[name] = torch.sqrt(torch.sum(torch.square(
                state[name[:-1] + 'v']), dim=rule[1], keepdim=True) + 1e-12)
    return state


def load(model, state):
    """Copy `state` into `model`'s parameters; every parameter must be in
    it, and nothing else"""
    parameters = dict(model.named_parameters())
    if set(parameters) != set(state):
        raise ValueError(
            f'state and model differ: {sorted(set(parameters) ^ set(state))}')
    with torch.no_grad():
        for name, parameter in parameters.items():
            parameter.copy_(state[name])
    return model
