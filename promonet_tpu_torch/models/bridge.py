"""Carry the JAX package's weights over to the port.

Each function takes a JAX parameter tree as nested dicts of numpy arrays
(as `promonet_tpu.utils.checkpoint.load(path)['params']` returns it; the
caller does the restore, so the port never needs orbax) and returns a
state dict for the port's module. Weight norm is materialised here, once,
in float32: g * v / sqrt(sum(v^2) + 1e-12), over axes (0, 1) of the
stride-1 (k, in, out) kernels (per output channel), over axes (0, 2) of
the transposed-conv kernels (per input channel) and over axis 0 of the
(in, out) dense kernels (per output). Transposed-conv taps are flipped
along k; dense kernels, GRU kernels included, are transposed to (out,
in), which keeps the GRU's gate order r, z, n. Every leaf must be used
exactly once: an unmapped or left-over leaf raises.

Only the generator (with any of its backbones), the pitch CNN and the
PPG encoder have weights. The
harmonics path, the 'dsp' pitch front end and both Viterbi decodes have
no parameters, so there is no converter for them.
"""
import numpy as np
import torch


class _Leaves:
    """Flat view of a parameter tree that checks every leaf is used once"""

    def __init__(self, tree):
        if set(tree) == {'params'}:
            tree = tree['params']
        self.leaves = {}
        self._flatten(tree, ())

    def _flatten(self, tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                self._flatten(value, prefix + (key,))
            else:
                self.leaves['/'.join(prefix + (key,))] = np.array(
                    value, np.float32)

    def take(self, path):
        if path not in self.leaves:
            raise KeyError(f'Parameter {path} is missing')
        return self.leaves.pop(path)

    def has(self, path):
        return path in self.leaves

    def finish(self, state):
        if self.leaves:
            raise ValueError(
                f'Unmapped parameters: {sorted(self.leaves)}')
        return {
            name: torch.from_numpy(np.ascontiguousarray(value))
            for name, value in state.items()}


def weight_norm(v, g, axes):
    """Effective kernel g * v / ||v|| (float32, norm over `axes`)"""
    norm = np.sqrt(
        np.sum(np.square(v), axis=axes, keepdims=True) + np.float32(1e-12))
    return v * (g / norm)


def _conv(leaves, path):
    """Plain (k, in, out) conv kernel → PyTorch (out, in, k)"""
    return leaves.take(f'{path}/kernel').transpose(2, 1, 0)


def _wn_conv(leaves, path):
    """Weight-normed stride-1 conv → effective (k, in, out), bias"""
    kernel = weight_norm(
        leaves.take(f'{path}/kernel_v'), leaves.take(f'{path}/kernel_g'),
        (0, 1))
    return kernel, leaves.take(f'{path}/bias')


def _wn_conv_transpose(leaves, path):
    """Weight-normed transposed conv → PyTorch (in, out, k) taps flipped"""
    kernel = weight_norm(
        leaves.take(f'{path}/kernel_v'), leaves.take(f'{path}/kernel_g'),
        (0, 2))
    return kernel[::-1].transpose(1, 2, 0), leaves.take(f'{path}/bias')


def _dense(leaves, path):
    """Dense (in, out) kernel → PyTorch (out, in)"""
    return leaves.take(f'{path}/kernel').T


def _wn_dense(leaves, path):
    """Weight-normed dense layer → effective PyTorch (out, in) weight"""
    return weight_norm(
        leaves.take(f'{path}/kernel_v'), leaves.take(f'{path}/kernel_g'),
        (0,)).T


def generator_state_dict(params):
    """`promonet_tpu.models.Generator` params → `models.Generator` state

    The backbone (HiFi-GAN, FARGAN or Vocos) is told by its leaves.
    """
    leaves = _Leaves(params)
    state = {
        'speaker_embedding.weight':
            leaves.take('speaker_embedding/embedding')}
    if leaves.has('pitch_embed/embedding'):
        state['pitch_embed.weight'] = leaves.take('pitch_embed/embedding')
    if leaves.has('backbone/ConditioningNetwork_0/Dense_0/kernel'):
        state.update(_fargan(leaves))
    elif leaves.has('backbone/ConvNeXtBlock_0/gamma'):
        state.update(_vocos(leaves))
    else:
        state.update(_hifigan(leaves))
    return leaves.finish(state)


def _hifigan(leaves):
    state = {
        'backbone.input_conv.weight': _conv(leaves, 'backbone/Conv1d_0'),
        'backbone.input_conv.bias': leaves.take('backbone/Conv1d_0/bias'),
        'backbone.global_conv.weight': _conv(leaves, 'backbone/Conv1d_1'),
        'backbone.global_conv.bias': leaves.take('backbone/Conv1d_1/bias'),
        'backbone.output_conv.weight': _conv(leaves, 'backbone/Conv1d_2'),
    }
    stage = 0
    while leaves.has(
            f'backbone/MultiReceptiveFieldFusion_{stage}/'
            'WNConvTranspose1d_0/kernel_v'):
        prefix = f'backbone/MultiReceptiveFieldFusion_{stage}'
        weight, bias = _wn_conv_transpose(
            leaves, f'{prefix}/WNConvTranspose1d_0')
        state[f'backbone.stages.{stage}.upsample.weight'] = weight
        state[f'backbone.stages.{stage}.upsample.bias'] = bias
        block = 0
        while leaves.has(
                f'{prefix}/ResidualBlock_0/Block_{block}/WNConv1d_0/bias'):
            # WNConv1d_{2n} is conv(k, d_n), WNConv1d_{2n+1} conv(k, 1)
            convs, conv = [], 0
            while leaves.has(
                    f'{prefix}/ResidualBlock_0/Block_{block}/'
                    f'WNConv1d_{conv}/bias'):
                convs.append(_wn_conv(
                    leaves,
                    f'{prefix}/ResidualBlock_0/Block_{block}/WNConv1d_{conv}'))
                conv += 1
            name = f'backbone.stages.{stage}.blocks.{block}'
            state[f'{name}.weight'] = np.stack([w for w, _ in convs])
            state[f'{name}.bias'] = np.stack([b for _, b in convs])
            block += 1
        stage += 1
    return state


def _fargan(leaves):
    state = {
        f'backbone.conditioning.layers.{i}.weight': _dense(
            leaves, f'backbone/ConditioningNetwork_0/Dense_{i}')
        for i in range(3)}
    network = 'backbone/ScanFrameStep_0/SubframeNetwork_0'
    ours = 'backbone.subframe'
    state[f'{ours}.fwconv.dense.weight'] = _wn_dense(
        leaves, f'{network}/FramewiseConv_0/WNDense_0')
    state[f'{ours}.fwconv.glu.dense.weight'] = _wn_dense(
        leaves, f'{network}/FramewiseConv_0/GLU_0/WNDense_0')
    for i in range(3):
        gru = f'{network}/GRUCellNoBias_{i}'
        state[f'{ours}.grus.{i}.weight_ih'] = _dense(leaves, f'{gru}/Dense_0')
        state[f'{ours}.grus.{i}.weight_hh'] = _dense(leaves, f'{gru}/Dense_1')
        state[f'{ours}.glus.{i}.dense.weight'] = _wn_dense(
            leaves, f'{network}/GLU_{i}/WNDense_0')
    # GLU_3 follows the three GRUs' GLUs: the skip path's
    state[f'{ours}.skip_glu.dense.weight'] = _wn_dense(
        leaves, f'{network}/GLU_3/WNDense_0')
    state[f'{ours}.skip.weight'] = _dense(leaves, f'{network}/Dense_0')
    state[f'{ours}.output.weight'] = _dense(leaves, f'{network}/Dense_1')
    return state


def _vocos(leaves):
    state = {}
    for name, path in (
        ('input_conv', 'Conv1d_0'), ('global_conv', 'Conv1d_1'),
        ('conv', 'Conv1d_2')
    ):
        state[f'backbone.{name}.weight'] = _conv(leaves, f'backbone/{path}')
        state[f'backbone.{name}.bias'] = leaves.take(f'backbone/{path}/bias')
    for name, path in (('norm', 'LayerNorm_0'), ('final_norm', 'LayerNorm_1')):
        state[f'backbone.{name}.weight'] = leaves.take(
            f'backbone/{path}/scale')
        state[f'backbone.{name}.bias'] = leaves.take(f'backbone/{path}/bias')
    state['backbone.head.weight'] = _dense(leaves, 'backbone/Dense_0')
    state['backbone.head.bias'] = leaves.take('backbone/Dense_0/bias')
    block = 0
    while leaves.has(f'backbone/ConvNeXtBlock_{block}/gamma'):
        path = f'backbone/ConvNeXtBlock_{block}'
        name = f'backbone.blocks.{block}'
        state[f'{name}.depthwise.weight'] = _conv(leaves, f'{path}/Conv_0')
        state[f'{name}.depthwise.bias'] = leaves.take(f'{path}/Conv_0/bias')
        state[f'{name}.norm.weight'] = leaves.take(
            f'{path}/LayerNorm_0/scale')
        state[f'{name}.norm.bias'] = leaves.take(f'{path}/LayerNorm_0/bias')
        for ours, theirs in (('pointwise', 'Dense_0'), ('project', 'Dense_1')):
            state[f'{name}.{ours}.weight'] = _dense(leaves, f'{path}/{theirs}')
            state[f'{name}.{ours}.bias'] = leaves.take(
                f'{path}/{theirs}/bias')
        state[f'{name}.gamma'] = leaves.take(f'{path}/gamma')
        block += 1
    return state


def _conv_norm_stack(leaves, layers):
    state = {}
    for i in range(layers):
        state[f'convs.{i}.weight'] = _conv(leaves, f'Conv_{i}')
        state[f'convs.{i}.bias'] = leaves.take(f'Conv_{i}/bias')
        state[f'norms.{i}.weight'] = leaves.take(f'LayerNorm_{i}/scale')
        state[f'norms.{i}.bias'] = leaves.take(f'LayerNorm_{i}/bias')
    state['output.weight'] = _dense(leaves, 'Dense_0')
    state['output.bias'] = leaves.take('Dense_0/bias')
    return state


def pitch_state_dict(params, layers=6):
    """`PitchCNN.Model` params → `preprocess.pitch.PitchCNN` state"""
    leaves = _Leaves(params)
    return leaves.finish(_conv_norm_stack(leaves, layers))


def ppg_state_dict(params, layers=6):
    """`PPGEncoder` params → `preprocess.ppg.PPGEncoder` state"""
    leaves = _Leaves(params)
    return leaves.finish(_conv_norm_stack(leaves, layers))
