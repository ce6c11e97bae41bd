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

Only the generator (with any of its backbones and either speaker
conditioning), CARGAN, the pitch CNN, the PPG encoder and the speaker
encoder have weights for inference. The harmonics path, the 'dsp' pitch front
end and both Viterbi decodes have no parameters, so there is no
converter for them.

Training (`train_state`) carries the JAX trainer's whole state instead:
the generator's trainable set with weight norm NOT materialised (each
`<name>_v` and `<name>_g` in the port's layout, `models.modules.split`),
the discriminators' (v, g) parameters, and each optax AdamW state as the
port's optimizer state ({'step', 'exp_avg', 'exp_avg_sq'} by parameter
name, `train.core`). Moments are laid out as their parameters: the same
flips and transposes, no norm.
"""
import numpy as np
import torch


class _Leaves:
    """Flat view of a parameter tree that checks every leaf is used once"""

    def __init__(self, tree):
        if set(tree) == {'params'}:
            tree = tree['params']
        self.leaves = {}
        self.materialize = True
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
            name: torch.from_numpy(np.array(value, order='C'))
            for name, value in state.items()}


def weight_norm(v, g, axes):
    """Effective kernel g * v / ||v|| (float32, norm over `axes`)"""
    norm = np.sqrt(
        np.sum(np.square(v), axis=axes, keepdims=True) + np.float32(1e-12))
    return v * (g / norm)


def _conv(leaves, path):
    """Plain (k, in, out) conv kernel → PyTorch (out, in, k)"""
    return leaves.take(f'{path}/kernel').transpose(2, 1, 0)


def _normed(leaves, path, axes, layout):
    """A weight-normed kernel: the effective weight when materialising,
    else {'_v': v, '_g': g}; `layout` maps the JAX layout to the port's"""
    v = leaves.take(f'{path}/kernel_v')
    g = leaves.take(f'{path}/kernel_g')
    if leaves.materialize:
        return layout(weight_norm(v, g, axes))
    return {'_v': layout(v), '_g': layout(g)}


def _put(state, name, kernel):
    """state[name] = an effective weight, or name_v and name_g = (v, g)"""
    if isinstance(kernel, dict):
        for suffix, value in kernel.items():
            state[f'{name}{suffix}'] = value
    else:
        state[name] = kernel


def _wn_conv(leaves, path):
    """Weight-normed stride-1 conv → (k, in, out) kernel (`_normed`),
    bias"""
    return (
        _normed(leaves, path, (0, 1), lambda x: x),
        leaves.take(f'{path}/bias'))


def _wn_conv_transpose(leaves, path):
    """Weight-normed transposed conv → PyTorch (in, out, k) kernel
    (`_normed`), taps flipped; bias"""
    return (
        _normed(leaves, path, (0, 2),
                lambda x: x[::-1].transpose(1, 2, 0)),
        leaves.take(f'{path}/bias'))


def _dense(leaves, path):
    """Dense (in, out) kernel → PyTorch (out, in)"""
    return leaves.take(f'{path}/kernel').T


def _wn_dense(leaves, path):
    """Weight-normed dense layer → PyTorch (out, in) kernel (`_normed`)"""
    return _normed(leaves, path, (0,), lambda x: x.T)


def generator_state_dict(params, materialize=True):
    """`promonet_tpu.models.Generator` params → `models.Generator` state

    The backbone (HiFi-GAN, FARGAN or Vocos) and the speaker conditioning
    (a learned table, or the zero-shot Dense over x-vectors) are told by
    their leaves. With materialize=False weight norm stays as (v, g): the
    trainer's trainable set (`models.modules.split`).
    """
    leaves = _Leaves(params)
    leaves.materialize = materialize
    if leaves.has('speaker_embedding/kernel'):
        state = {
            'speaker_embedding.weight': _dense(leaves, 'speaker_embedding'),
            'speaker_embedding.bias': leaves.take('speaker_embedding/bias')}
    else:
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


def _hifigan(leaves, path='backbone', name='backbone'):
    """A HiFi-GAN's leaves under `path` → the port's HiFiGAN state under
    `name`"""
    state = {
        f'{name}.input_conv.weight': _conv(leaves, f'{path}/Conv1d_0'),
        f'{name}.input_conv.bias': leaves.take(f'{path}/Conv1d_0/bias'),
        f'{name}.global_conv.weight': _conv(leaves, f'{path}/Conv1d_1'),
        f'{name}.global_conv.bias': leaves.take(f'{path}/Conv1d_1/bias'),
        f'{name}.output_conv.weight': _conv(leaves, f'{path}/Conv1d_2'),
    }
    stage = 0
    while leaves.has(
            f'{path}/MultiReceptiveFieldFusion_{stage}/'
            'WNConvTranspose1d_0/kernel_v'):
        prefix = f'{path}/MultiReceptiveFieldFusion_{stage}'
        parts, bias = _wn_conv_transpose(
            leaves, f'{prefix}/WNConvTranspose1d_0')
        _put(state, f'{name}.stages.{stage}.upsample.weight', parts)
        state[f'{name}.stages.{stage}.upsample.bias'] = bias
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
            block_name = f'{name}.stages.{stage}.blocks.{block}'
            if leaves.materialize:
                state[f'{block_name}.weight'] = np.stack(
                    [w for w, _ in convs])
            else:
                _put(state, f'{block_name}.weight', {
                    suffix: np.stack([parts[suffix] for parts, _ in convs])
                    for suffix in ('_v', '_g')})
            state[f'{block_name}.bias'] = np.stack([b for _, b in convs])
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
    _put(state, f'{ours}.fwconv.dense.weight', _wn_dense(
        leaves, f'{network}/FramewiseConv_0/WNDense_0'))
    _put(state, f'{ours}.fwconv.glu.dense.weight', _wn_dense(
        leaves, f'{network}/FramewiseConv_0/GLU_0/WNDense_0'))
    for i in range(3):
        gru = f'{network}/GRUCellNoBias_{i}'
        state[f'{ours}.grus.{i}.weight_ih'] = _dense(leaves, f'{gru}/Dense_0')
        state[f'{ours}.grus.{i}.weight_hh'] = _dense(leaves, f'{gru}/Dense_1')
        _put(state, f'{ours}.glus.{i}.dense.weight', _wn_dense(
            leaves, f'{network}/GLU_{i}/WNDense_0'))
    # GLU_3 follows the three GRUs' GLUs: the skip path's
    _put(state, f'{ours}.skip_glu.dense.weight', _wn_dense(
        leaves, f'{network}/GLU_3/WNDense_0'))
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


def cargan_state_dict(params):
    """`promonet_tpu.models.CARGAN` params → `models.cargan.CARGAN` state:
    the autoregressive encoder's three dense layers and the HiFi-GAN
    (effective weights)"""
    leaves = _Leaves(params)
    state = {}
    for i in range(3):
        path = f'Autoregressive_0/Dense_{i}'
        state[f'autoregressive.layers.{i}.weight'] = _dense(leaves, path)
        state[f'autoregressive.layers.{i}.bias'] = leaves.take(
            f'{path}/bias')
    state.update(_hifigan(leaves, 'HiFiGAN_0', 'hifigan'))
    return leaves.finish(state)


def discriminator_state_dict(params):
    """`promonet_tpu.models.Discriminator` params → `models.Discriminator`
    state: (v, g) and bias of every convolution, in PyTorch's layouts
    ((out, in, kh, kw) and (out, in // groups, k))"""
    leaves = _Leaves(params)
    state = {}
    index = 0
    while leaves.has(f'discriminators_{index}/WNConv2d_0/bias') or \
            leaves.has(f'discriminators_{index}/WNConv1d_0/bias'):
        kind = (
            'WNConv2d' if leaves.has(f'discriminators_{index}/WNConv2d_0/bias')
            else 'WNConv1d')
        # (kh, kw, in, out) → (out, in, kh, kw); (k, in, out) → (out, in, k)
        order = (3, 2, 0, 1) if kind == 'WNConv2d' else (2, 1, 0)
        conv = 0
        while leaves.has(f'discriminators_{index}/{kind}_{conv}/bias'):
            path = f'discriminators_{index}/{kind}_{conv}'
            name = f'discriminators.{index}.convs.{conv}'
            for ours, theirs in (('weight_v', 'kernel_v'),
                                 ('weight_g', 'kernel_g')):
                state[f'{name}.{ours}'] = leaves.take(
                    f'{path}/{theirs}').transpose(order)
            state[f'{name}.bias'] = leaves.take(f'{path}/bias')
            conv += 1
        index += 1
    return leaves.finish(state)


def _adam(opt_state):
    """The ScaleByAdamState (count, mu, nu) of an optax AdamW state"""
    if hasattr(opt_state, 'mu') and hasattr(opt_state, 'nu'):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam(part)
            if found is not None:
                return found
    return None


def optimizer_state(opt_state, convert):
    """An optax AdamW state → the port's optimizer state {'step',
    'exp_avg', 'exp_avg_sq'}, the moments laid out by `convert` (a
    params-tree converter of this module)"""
    adam = _adam(opt_state)
    if adam is None:
        raise ValueError('No Adam moments in the optimizer state')
    return {
        'step': int(np.asarray(adam.count)),
        'exp_avg': convert(adam.mu),
        'exp_avg_sq': convert(adam.nu)}


def train_state(state):
    """The JAX trainer's state (`promonet_tpu.train.create_state`, as
    numpy) → {'generator': {'trainable', 'optimizer'}, 'discriminator':
    {'params', 'optimizer'}} of the port's trainer"""
    def trainable(tree):
        return generator_state_dict(tree, materialize=False)

    return {
        'generator': {
            'trainable': trainable(state['generator']['params']),
            'optimizer': optimizer_state(
                state['generator']['opt_state'], trainable)},
        'discriminator': {
            'params': discriminator_state_dict(
                state['discriminator']['params']),
            'optimizer': optimizer_state(
                state['discriminator']['opt_state'],
                discriminator_state_dict)}}


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


def speaker_state_dict(params, layers=4):
    """`SpeakerEncoder` params → `preprocess.speaker.SpeakerEncoder` state"""
    leaves = _Leaves(params)
    return leaves.finish(_conv_norm_stack(leaves, layers))
