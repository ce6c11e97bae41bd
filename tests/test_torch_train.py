"""The port's training step held against the JAX package's.

A narrow configuration on both sides (HiFi-GAN 32 channels, CHUNK_SIZE
2048, batch 2, multi-period and complex multi-band discriminators, no
remat): the JAX package's `create_state` and jitted step, and the port's
`train_step` from the same state carried across by the bridge, on
numpy-seeded batches. The JAX optimizers are wrapped to keep each step's
raw gradients in their state, so both packages' gradients are compared
without changing the step.

Tolerances, float32 on both sides:
- weight norm: the materialised weight within 5e-7 relative of the JAX
  package's (and the JAX module's own kernel): four float32 steps, since
  XLA sums the squares in another order than PyTorch (sequentially for
  small kernels, blocked for large ones; 3.2e-7 at most is seen at the
  full-width shapes);
- step 1 from `create_state`: every loss within 1e-5 relative, every
  gradient leaf within 1e-4 of its largest magnitude (a v leaf's
  magnitude includes its radial part, see `_scales`), the
  discriminators' within 2e-2: in float32 a pre-activation within
  rounding of zero takes the other side of a leaky ReLU now and then,
  which moves a first convolution's gradient by up to 1% of its largest
  value (`tests/test_torch_discriminator.py` holds every family's
  gradients to 1e-4 in float64, where none does); updated weights
  within 1e-6, except where AdamW's first step (±lr wherever |g| >> eps)
  takes the other sign, and then within 2 lr;
- step 2 from JAX's state after step 1: losses within 2e-6 relative (+
  1e-6), gradients as in step 1, updated
  weights of both models within 1e-6, except at elements whose gradient
  lies within that gradient tolerance of zero, where AdamW's normalised
  step m / sqrt(v) follows the rounding of the gradient itself: within
  2 lr there, as in step 1. Float32 carries about 7 digits, so losses of
  ~240 and gradients of ~100 cannot agree to 1e-6 absolute;
- bf16: every loss within 2e-2 relative.

The Vocos and spectrogram-only generators' steps are in
`test_torch_train_baselines.py`, runs and checkpoints in
`test_torch_train_runs.py`; both import the helpers here.
"""
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import promonet_tpu
from promonet_tpu.models import modules as jax_modules
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge, modules
from promonet_tpu_torch.train import core, graphs

ROOT = Path(__file__).resolve().parent.parent
NARROW = dict(
    HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
    REMAT=False, PRECISION='float32')
LR = 2e-4


def drop_large_files(directory, size=2 ** 20):
    """Delete the files over `size` bytes that a test wrote under
    `directory`, never through a symbolic link: its checkpoints (a
    discriminator's with its optimizer state is about half a gigabyte).
    pytest keeps the temporary directories of its last three runs, and
    without this the suite leaves about 6 GB in each"""
    for parent, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(parent, name)
            if not os.path.islink(path) and os.path.getsize(path) > size:
                os.remove(path)


def _batch(seed, batch=2, frames=8):
    rng = np.random.default_rng(seed)
    ppg = rng.random((batch, 40, frames)).astype(np.float32)
    return {
        'loudness': rng.uniform(-80, 0, (batch, 513, frames)).astype(
            np.float32),
        'pitch': rng.uniform(80, 300, (batch, frames)).astype(np.float32),
        'periodicity': rng.random((batch, frames)).astype(np.float32),
        'ppg': ppg / ppg.sum(1, keepdims=True),
        'speakers': np.array([3, 7], np.int32)[:batch],
        'spectral_balance_ratios': np.array([1., 1.2], np.float32)[:batch],
        'loudness_ratios': np.array([.9, 1.], np.float32)[:batch],
        'spectrograms': np.abs(rng.standard_normal(
            (batch, 513, frames))).astype(np.float32) + 1e-3,
        'audio': (0.3 * rng.standard_normal(
            (batch, 1, frames * 256))).astype(np.float32)}


def _recording_optimizer():
    """The JAX optimizer behind a transform that keeps the raw gradients
    as its state (the updates pass through unchanged)"""
    original = jax_core.build_optimizer

    def build():
        record = optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))
        return optax.chain(record, original())

    return build


def _jax_steps(precision, steps, initial=None, **overrides):
    """JAX states before and after each step, and each step's metrics;
    the first state is `create_state`'s unless `initial` is given"""
    with pytest.MonkeyPatch.context() as patch:
        for name, value in dict(
                NARROW, PRECISION=precision, **overrides).items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(jax_core, 'build_optimizer', _recording_optimizer())
        states = [initial if initial is not None else jax.device_get(
            jax_core.create_state(jax.random.PRNGKey(0)))]
        step = jax_core.make_train_step()
        metrics = []
        for i in range(steps):
            state, values = step(
                jax.tree.map(jnp.asarray, states[-1]), _batch(i),
                jax.random.PRNGKey(i + 1))
            states.append(jax.device_get(state))
            metrics.append(jax.device_get(values))
    return states, metrics


@pytest.fixture(scope='module')
def float32_steps():
    return _jax_steps('float32', 2)


def _config(**overrides):
    return port.config.load().replace(**dict(NARROW, **overrides))


def _port_state(jax_state, config):
    """A port `State` holding the JAX trainer's state"""
    state = core.create_state(config, 'cpu')
    carried = bridge.train_state(jax_state)
    with torch.no_grad():
        for name, value in carried['generator']['trainable'].items():
            state.trainable[name].copy_(value)
    state.discriminator.load_state_dict(carried['discriminator']['params'])
    if carried['generator']['optimizer']['step']:
        core.load_optimizer_state(
            state.generator_optimizer, state.names,
            [state.trainable[name] for name in state.names],
            carried['generator']['optimizer'])
        names, parameters = core._discriminator_parameters(state)
        core.load_optimizer_state(
            state.discriminator_optimizer, names, parameters,
            carried['discriminator']['optimizer'])
    return state


def _record_gradients(state):
    """{'generator': {name: gradient}, 'discriminator': {...}} of the next
    `train_step`, kept as each optimizer steps"""
    gradients = {}
    d_names, d_parameters = core._discriminator_parameters(state)
    for key, optimizer, names, parameters in (
        ('generator', state.generator_optimizer, state.names,
         [state.trainable[name] for name in state.names]),
        ('discriminator', state.discriminator_optimizer, d_names,
         d_parameters)
    ):
        def step(original=optimizer.step, key=key, names=names,
                 parameters=parameters):
            gradients[key] = {
                name: parameter.grad.clone()
                for name, parameter in zip(names, parameters)}
            return original()

        optimizer.step = step
    return gradients


def _jax_gradients(state):
    """The recorded gradients in a JAX state, in the port's layout"""
    return {
        'generator': bridge.generator_state_dict(
            state['generator']['opt_state'][0], materialize=False),
        'discriminator': bridge.discriminator_state_dict(
            state['discriminator']['opt_state'][0])}


def _scales(gradients, params):
    """Each leaf's gradient scale: its largest magnitude, and for a v
    leaf also that of the weight's gradient it comes from

    The gradient of v is the effective weight's times g / ||v||, with its
    component along v removed; that component is g / ||v|| times the
    gradient of g. Where the two nearly cancel (the discriminators' first
    convolutions, five taps per channel), float32 leaves an error at the
    scale of the weight's gradient, not of the small difference.
    """
    scales = {}
    for name, gradient in gradients.items():
        scale = float(gradient.abs().max())
        if name.endswith('_v') and f'{name[:-2]}_g' in gradients:
            v, g = params[name], params[f'{name[:-2]}_g']
            axes = tuple(range(1, v.dim()))
            radial = (gradients[f'{name[:-2]}_g'] * g).abs() / torch.sqrt(
                torch.sum(v * v, dim=axes, keepdim=True))
            scale = max(scale, float(radial.max()))
        scales[name] = scale
    return scales


# Gradient tolerances, relative to each leaf's scale (see the module)
GRADIENT_TOLERANCE = {'generator': 1e-4, 'discriminator': 2e-2}


def _assert_gradients_close(ours, theirs, params):
    for model in ('generator', 'discriminator'):
        assert set(ours[model]) == set(theirs[model])
        scales = _scales(theirs[model], params[model])
        for name, expected in theirs[model].items():
            error = float((ours[model][name] - expected).abs().max())
            assert error <= GRADIENT_TOLERANCE[model] * scales[name], (
                model, name, error, scales[name])


def _params(jax_state):
    """The parameters of a JAX state in the port's layout"""
    carried = bridge.train_state(jax_state)
    return {'generator': carried['generator']['trainable'],
            'discriminator': carried['discriminator']['params']}


def _run_port_step(jax_state, config, seed):
    state = _port_state(jax_state, config)
    gradients = _record_gradients(state)
    metrics = core.train_step(
        state, core.to_device(_batch(seed), torch.device('cpu')))
    return state, gradients, metrics


###############################################################################
# Weight norm and the bridge
###############################################################################


def test_weight_norm_matches_jax():
    rng = np.random.default_rng(0)
    for shape, axes, ours_axes, layout in (
        ((7, 16, 24), (0, 1), (1, 2), lambda x: x[None]),
        ((11, 256, 256), (0, 1), (1, 2), lambda x: x[None]),
        ((16, 512, 256), (0, 2), (1, 2),
         lambda x: x[::-1].transpose(1, 2, 0)),
        ((5, 1, 512, 1024), (0, 1, 2), (1, 2, 3),
         lambda x: x.transpose(3, 2, 0, 1)),
        ((40, 24), (0,), (1,), lambda x: x.T),
    ):
        v = rng.standard_normal(shape).astype(np.float32)
        g = np.abs(rng.standard_normal(
            [1 if i in axes else n for i, n in enumerate(shape)])).astype(
                np.float32)
        norm = jnp.sqrt(jnp.sum(jnp.square(v), axis=axes, keepdims=True) +
                        1e-12)
        theirs = np.asarray(v * (g / norm))
        ours = modules.weight_norm(
            torch.from_numpy(np.array(layout(v))),
            torch.from_numpy(np.array(layout(g))), ours_axes).numpy()
        np.testing.assert_allclose(ours, layout(theirs), rtol=5e-7, atol=0)


def test_weight_norm_matches_the_jax_module():
    """The JAX module's own (v, g) → kernel, against `split`/`materialize`"""
    x = jnp.zeros((1, 9, 12))
    conv = jax_modules.WNConv1d(20, 7, dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(3), x)
    kernel, _ = conv.apply(params, x, materialize_only=True)
    v = np.asarray(params['params']['kernel_v'])
    # Another g than the initial norm
    g = 1.5 * np.asarray(params['params']['kernel_g'])
    kernel, _ = conv.apply(
        {'params': dict(params['params'], kernel_g=g)}, x,
        materialize_only=True)
    trainable = {
        'weight_v': torch.from_numpy(v.transpose(2, 1, 0).copy()),
        'weight_g': torch.from_numpy(g.transpose(2, 1, 0).copy()),
        'bias': torch.zeros(20)}
    ours = modules.materialize(trainable, {'weight': (1, 2)})['weight']
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(kernel).transpose(2, 1, 0), rtol=5e-7,
        atol=0)
    # split gives g = the norm, and materialize the weight back
    back = modules.materialize(
        modules.split({'weight': ours}, {'weight': (1, 2)}),
        {'weight': (1, 2)})['weight']
    np.testing.assert_allclose(back.numpy(), ours.numpy(), rtol=1e-6)


def test_train_state_round_trip_uses_every_leaf(float32_steps):
    states, _ = float32_steps
    state = states[1]
    carried = bridge.train_state(state)
    config = _config()
    ours = core.create_state(config, 'cpu')
    assert set(carried['generator']['trainable']) == set(ours.trainable)
    for name, value in carried['generator']['trainable'].items():
        assert value.shape == ours.trainable[name].shape, name
    ours.discriminator.load_state_dict(
        carried['discriminator']['params'], strict=True)
    for model, optimizer in (
        ('generator', carried['generator']['optimizer']),
        ('discriminator', carried['discriminator']['optimizer'])
    ):
        assert optimizer['step'] == 1
        names = set(
            carried['generator']['trainable'] if model == 'generator'
            else carried['discriminator']['params'])
        assert set(optimizer['exp_avg']) == set(optimizer['exp_avg_sq']) \
            == names
    # Every leaf carried once (the bridge raises on a left-over leaf): the
    # same number of values on both sides, moments included
    def values(tree):
        return sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))

    def ours_values(tensors):
        return sum(value.numel() for value in tensors.values())

    for model, params in (
        ('generator', carried['generator']['trainable']),
        ('discriminator', carried['discriminator']['params'])
    ):
        assert values(state[model]['params']) == ours_values(params)
        optimizer = carried[model]['optimizer']
        assert 2 * values(state[model]['params']) + 1 == ours_values(
            optimizer['exp_avg']) + ours_values(optimizer['exp_avg_sq']) + 1
    # The materialised trainable set is the inference bridge's state
    effective = modules.materialize(
        carried['generator']['trainable'], ours.normed)
    inference = bridge.generator_state_dict(state['generator']['params'])
    assert set(effective) == set(inference)
    for name, value in inference.items():
        np.testing.assert_allclose(
            effective[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-7)


###############################################################################
# The step
###############################################################################


def _assert_first_step_matches(states, metrics, state, gradients, ours):
    assert set(ours) == set(metrics[0])
    for name, value in metrics[0].items():
        if name.startswith('gradients/'):
            continue
        np.testing.assert_allclose(
            float(ours[name]), float(value), rtol=1e-5, err_msg=name)
    theirs = _jax_gradients(states[1])
    _assert_gradients_close(gradients, theirs, _params(states[0]))
    for name in ('max', 'min'):
        scale = max(float(v.abs().max())
                    for v in theirs['generator'].values())
        assert abs(float(ours[f'gradients/{name}']) -
                   float(metrics[0][f'gradients/{name}'])) <= 1e-4 * scale
    after = bridge.train_state(states[1])
    updated = (
        [(state.trainable[name].detach(), value)
         for name, value in after['generator']['trainable'].items()] +
        [(parameter.detach(), after['discriminator']['params'][name])
         for name, parameter in state.discriminator.named_parameters()])
    flips = 0
    for ours_value, value in updated:
        error = (ours_value - value).abs()
        assert float(error.max()) <= 2 * LR + 1e-6
        flips += int((error > 1e-6).sum())
    # Sign flips of AdamW's first step are rare
    total = sum(value.numel() for _, value in updated)
    assert flips <= 1e-3 * total


def test_first_step_matches_jax(float32_steps):
    states, metrics = float32_steps
    _assert_first_step_matches(
        states, metrics, *_run_port_step(states[0], _config(), 0))


def test_second_step_from_the_jax_state_matches_jax(float32_steps):
    states, metrics = float32_steps
    state, gradients, ours = _run_port_step(states[1], _config(), 1)
    for name, value in metrics[1].items():
        if name.startswith('gradients/'):
            continue
        np.testing.assert_allclose(
            float(ours[name]), float(value), rtol=2e-6, atol=1e-6,
            err_msg=name)
    theirs = _jax_gradients(states[2])
    _assert_gradients_close(gradients, theirs, _params(states[1]))
    after = bridge.train_state(states[2])
    scales = {
        model: _scales(theirs[model], _params(states[1])[model])
        for model in theirs}
    pairs = [
        (state.trainable[name].detach(), value,
         theirs['generator'][name], scales['generator'][name])
        for name, value in after['generator']['trainable'].items()] + [
        (parameter.detach(), after['discriminator']['params'][name],
         theirs['discriminator'][name], scales['discriminator'][name])
        for name, parameter in state.discriminator.named_parameters()]
    tolerances = [GRADIENT_TOLERANCE['generator']] * len(
        after['generator']['trainable']) + [
        GRADIENT_TOLERANCE['discriminator']] * len(
        after['discriminator']['params'])
    for (ours_value, value, gradient, scale), tolerance in zip(
            pairs, tolerances):
        error = (ours_value - value).abs()
        noise = gradient.abs() <= tolerance * scale
        if (~noise).any():
            assert float(error[~noise].max()) <= 1e-6
        assert float(error.max()) <= 2 * LR


def test_bfloat16_step_matches_jax(float32_steps):
    states, metrics = _jax_steps(
        'bfloat16', 1, initial=float32_steps[0][0])
    _, _, ours = _run_port_step(
        states[0], _config(PRECISION='bfloat16'), 0)
    for name, value in metrics[0].items():
        if name.startswith('gradients/'):
            continue
        np.testing.assert_allclose(
            float(ours[name]), float(value), rtol=2e-2, err_msg=name)


def test_remat_changes_nothing(float32_steps):
    """REMAT recomputes each Block and discriminator in the backward pass:
    the same losses and gradients"""
    states, _ = float32_steps
    results = [
        _run_port_step(states[0], _config(REMAT=remat), 0)
        for remat in (False, True)]
    for name, value in results[0][2].items():
        np.testing.assert_allclose(
            float(results[1][2][name]), float(value), rtol=1e-6,
            err_msg=name)
    _assert_gradients_close(results[1][1], results[0][1], _params(states[0]))


def test_example_batch_matches_jax(monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'CHUNK_SIZE', 2048)
    theirs = jax_core.example_batch(batch_size=3)
    ours = core.example_batch(_config(), batch_size=3)
    assert set(ours) == set(theirs)
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
        assert ours[name].dtype == value.dtype, name


def test_training_route_never_reaches_the_kernel(monkeypatch):
    """train=True runs each Block's differentiable chain; train=False is
    the inference route through `fused_block`, 12 calls per generator
    call"""
    from promonet_tpu_torch.models import hifigan
    calls = []
    original = hifigan.fused_block

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(hifigan, 'fused_block', counted)
    config = _config()
    generator = port.models.init.seeded(port.models.Generator(config), 0)
    batch = core.to_device(_batch(0), torch.device('cpu'))
    trained = generator(*core.generator_args(batch, config), train=True)
    assert calls == [] and trained.requires_grad
    inferred = generator(*core.generator_args(batch, config))
    assert len(calls) == 12
    np.testing.assert_allclose(
        trained.detach().numpy(), inferred.detach().numpy(), atol=2e-6)


###############################################################################
# The rules of the CUDA graphs (`train.graphs`) that the CPU can see
###############################################################################

@pytest.fixture(scope='module')
def stepped():
    """A narrow state after one step (AdamW's state made), and its batch"""
    state = core.create_state(_config(), 'cpu')
    batch = core.to_device(_batch(0), torch.device('cpu'))
    core.train_step(state, batch)
    return state, batch


def _on_a_card(state):
    """`state` as `graphs.graphable` would see it on a card: its models,
    optimizers and mesh, its device CUDA (with a batch of no tensors)"""
    return types.SimpleNamespace(
        device=torch.device('cuda'), generator=state.generator,
        discriminator=state.discriminator,
        generator_optimizer=state.generator_optimizer,
        discriminator_optimizer=state.discriminator_optimizer,
        mesh=state.mesh)


HOOKS = {
    'generator pre-hook': lambda state: (
        state.generator.register_forward_pre_hook(lambda *_: None)),
    'discriminator pre-hook': lambda state: (
        state.discriminator.register_forward_pre_hook(lambda *_: None)),
    'discriminator forward hook': lambda state: (
        state.discriminator.register_forward_hook(lambda *_: None)),
    'submodule forward hook': lambda state: (
        state.generator.backbone.register_forward_hook(lambda *_: None)),
    'backward hook': lambda state: (
        state.discriminator.discriminators[0].register_full_backward_hook(
            lambda *_: None)),
    'global forward hook': lambda state: (
        torch.nn.modules.module.register_module_forward_hook(
            lambda *_: None)),
}


@pytest.mark.parametrize('case', list(HOOKS))
def test_a_hook_keeps_the_steps_eager(stepped, case):
    """A hook that a graph would fire at its capture only makes every step
    eager; removed, the step may be graphed again"""
    state, _ = stepped
    handle = HOOKS[case](state)
    try:
        hooked = graphs.graphable(_on_a_card(state), {}, None)
    finally:
        handle.remove()
    assert not hooked
    assert graphs.graphable(_on_a_card(state), {}, None)


def test_a_generator_forward_hook_leaves_steps_graphable(stepped):
    """The generator's own forward hooks are called after a replay"""
    state, _ = stepped
    handle = state.generator.register_forward_hook(lambda *_: None)
    try:
        assert graphs.graphable(_on_a_card(state), {}, None)
    finally:
        handle.remove()


def test_the_cpu_and_a_given_noise_keep_the_steps_eager(stepped):
    """A CPU step is eager, and so is a step given a noise source or one
    whose batch holds a tensor off the card; an optimizer that cannot be
    capturable (SGD) keeps every step eager"""
    state, batch = stepped
    card = _on_a_card(state)
    assert not graphs.graphable(state, batch, None)
    assert not graphs.graphable(card, batch, None)
    assert not graphs.graphable(card, {}, lambda x: torch.rand_like(x))
    card.discriminator_optimizer = torch.optim.SGD(
        state.discriminator.parameters(), lr=1e-3)
    assert not graphs.graphable(card, {}, None)


def _swap_moment(state, batch):
    leaf = state.trainable[state.names[0]]
    moments = state.generator_optimizer.state[leaf]
    moments['exp_avg'] = moments['exp_avg'].clone()
    return batch


def _swap_leaf(state, batch):
    leaf = state.discriminator.discriminators[0].convs[0].weight_v
    leaf.data = leaf.data.clone()
    return batch


def _new_rate(state, batch):
    state.discriminator_optimizer.param_groups[0]['lr'] *= 2
    return batch


KEY_CHANGES = {
    'a shorter batch': lambda state, batch: dict(
        batch, audio=batch['audio'][:1]),
    'another dtype': lambda state, batch: dict(
        batch, speakers=batch['speakers'].int()),
    'new optimizer state': _swap_moment,
    'a swapped leaf': _swap_leaf,
    'a new learning rate': _new_rate,
}


@pytest.mark.parametrize('change', list(KEY_CHANGES))
def test_what_changes_a_steps_key(stepped, change):
    """A batch of other shapes or dtypes, a tensor the step updates
    swapped for another, or a changed optimizer setting: another key,
    whose first step runs eagerly (the changes are left in place: the
    state stays a state that steps)"""
    state, batch = stepped
    group = state.discriminator_optimizer.param_groups[0]
    rate = group['lr']
    before = graphs.key(state, batch, True, True)
    try:
        changed = KEY_CHANGES[change](state, batch)
        assert graphs.key(state, changed, True, True) != before
    finally:
        group['lr'] = rate


def test_the_switches_are_in_the_key(stepped):
    state, batch = stepped
    key = graphs.key(state, batch, True, True)
    assert graphs.key(state, batch, False, True) != key
    assert graphs.key(state, batch, True, False) != key


def test_a_process_group_keeps_the_steps_eager(stepped):
    """NCCL's all-reduces inside graphs hung on four cards"""
    state, _ = stepped
    card = _on_a_card(state)
    card.mesh = port.parallel.Mesh({'data': 1}, group=True)
    assert not graphs.graphable(card, {}, None)
    card.mesh = port.parallel.Mesh({'data': 1})
    assert graphs.graphable(card, {}, None)


def test_a_step_keeps_its_key(stepped):
    """The step updates its tensors in place: the key of the step after
    it is the key it had, so that step is captured"""
    state, batch = stepped
    key = graphs.key(state, batch, True, True)
    calls = []
    handle = state.generator.register_forward_hook(
        lambda module, args, output: calls.append(
            (module, len(args), tuple(output.shape))))
    try:
        metrics = core.train_step(state, batch)
    finally:
        handle.remove()
    assert graphs.key(state, batch, True, True) == key
    # A hook fires once a step, with the generator's seven inputs
    assert calls == [(state.generator, 7, (2, 1, 2048))]
    assert state.graphs is None
    assert all(value.shape == () for value in metrics.values())


@pytest.mark.parametrize('device', ['cpu', 'meta'])
def test_a_loaded_step_count_lies_on_the_parameters_device(device):
    """Where a capturable optimizer keeps it; a plain one keeps it on the
    host"""
    for capturable in (True, False):
        parameters = [torch.nn.Parameter(torch.zeros(3, device=device))]
        optimizer = torch.optim.AdamW(parameters, capturable=capturable)
        core.load_optimizer_state(optimizer, ['w'], parameters, {
            'step': 5, 'exp_avg': {'w': torch.ones(3)},
            'exp_avg_sq': {'w': torch.ones(3)}})
        saved = optimizer.state[parameters[0]]
        assert saved['step'].device.type == (
            device if capturable else 'cpu')
        assert saved['exp_avg'].device.type == device
        if saved['step'].device.type == 'cpu':
            assert float(saved['step']) == 5.


@pytest.mark.parametrize('device', ['cpu', 'meta'])
def test_capturable_mode_moves_the_step_counts(device):
    """On: AdamW capturable, its step counts on the parameters' device (a
    second call changes nothing); off: plain, the counts on the host (a
    meta count has no value to bring back); SGD has no such mode"""
    parameters = [torch.nn.Parameter(torch.zeros(3, device=device))]
    state = types.SimpleNamespace(
        generator_optimizer=torch.optim.AdamW(parameters),
        discriminator_optimizer=torch.optim.SGD(parameters, lr=1e-3))
    saved = state.generator_optimizer.state[parameters[0]] = {
        'step': torch.tensor(5.)}
    switches = [(True, device), (True, device)] + (
        [(False, 'cpu')] if device == 'cpu' else [])
    for on, where in switches:
        count = saved['step']
        graphs.capturable(state, on)
        assert state.generator_optimizer.param_groups[0]['capturable'] is on
        assert saved['step'].device.type == where
        assert 'capturable' not in \
            state.discriminator_optimizer.param_groups[0]
    assert saved['step'] is count
    if device == 'cpu':
        assert float(saved['step']) == 5.


def test_an_eager_step_runs_plain_optimizers(stepped):
    """A step that cannot be graphed (here on the CPU) takes Adam and
    AdamW out of capturable mode, whose extra launches only a replay
    hides"""
    state, batch = stepped
    graphs.capturable(state, True)
    core.train_step(state, batch)
    for optimizer in (state.generator_optimizer,
                      state.discriminator_optimizer):
        assert optimizer.param_groups[0]['capturable'] is False
        assert all(saved['step'].device.type == 'cpu'
                   for saved in optimizer.state.values())


def test_a_replay_calls_the_forward_hooks_as_a_call_would():
    """Each hook once, with or without the call's keyword arguments"""
    module = torch.nn.Linear(2, 2)
    calls = []
    module.register_forward_hook(
        lambda *arguments: calls.append(('plain', arguments)))
    module.register_forward_hook(
        lambda *arguments: calls.append(('kwargs', arguments)),
        with_kwargs=True)
    args, kwargs, output = (torch.ones(2),), {'train': True}, torch.zeros(2)
    graphs.call_forward_hooks(module, args, kwargs, output)
    assert calls == [('plain', (module, args, output)),
                     ('kwargs', (module, args, kwargs, output))]


def test_a_hook_may_not_replace_a_replayed_output():
    module = torch.nn.Linear(2, 2)
    module.register_forward_hook(lambda module, args, output: output + 1)
    with pytest.raises(RuntimeError, match='forward pre-hook'):
        graphs.call_forward_hooks(module, (), {}, torch.zeros(2))
