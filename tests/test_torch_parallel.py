"""The port's data parallelism (`parallel`, the trainer's all-reduce) held
against a single process and the JAX package's data mesh.

- `create_mesh` without a process group is a world of one; a
  MESH_SHAPE that disagrees with the world raises;
- `shard_batch` keeps this rank's contiguous block of rows;
- `parameter_shardings` in the port's layout equals the JAX package's on
  its 8-device CPU mesh {'data': 4, 'model': 2}, each JAX leaf carried
  to the port's layout by the bridge (`models.bridge`) with its trailing
  axis marked;
- one spawn of 2 gloo ranks on the CPU, narrow and float32, takes one
  `train_step` on a global batch of 4: both ranks end with equal
  weights; their averaged losses and all-reduced gradients match a
  single process's step on the whole batch and the JAX package's step
  with MESH_SHAPE = {'data': 2} on the same weights and batch, with
  `test_torch_train.py`'s tolerances (losses within 1e-5 relative,
  gradient leaves within GRADIENT_TOLERANCE of their scale, updated
  weights within 1e-6 except where AdamW's first step takes the other
  sign near a zero gradient, and within 2 lr there).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import promonet_tpu
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch import parallel
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.train import core

from test_torch_train import (
    LR, NARROW, _assert_first_step_matches, _assert_gradients_close, _batch,
    _params, _port_state, _recording_optimizer, _record_gradients)

ROOT = Path(__file__).resolve().parent.parent
jax_mesh = __import__('promonet_tpu.parallel.mesh', fromlist=['mesh'])
BATCH = 4


# The narrow configuration of `test_torch_train.py` at batch 4, cut to two
# upsampling stages of one Block each and the multi-period discriminators
# alone, which halves the JAX package's compile
SMALL = dict(
    NARROW, BATCH_SIZE=BATCH, COMPLEX_MULTIBAND_DISCRIMINATOR=False,
    HIFIGAN_RESBLOCK_KERNEL_SIZES=[3],
    HIFIGAN_RESBLOCK_DILATION_SIZES=[[1, 3, 5]],
    HIFIGAN_UPSAMPLE_KERNEL_SIZES=[16, 16], HIFIGAN_UPSAMPLE_RATES=[16, 16])


def _config(**overrides):
    return port.config.load().replace(**dict(SMALL, **overrides))


def _global_batch(seed):
    """A numpy-seeded batch of four"""
    halves = _batch(seed), _batch(seed + 100)
    return {name: np.concatenate([half[name] for half in halves])
            for name in halves[0]}


@pytest.fixture(scope='module')
def jax_step():
    """([state before, state after], [metrics]) of the JAX package's step
    on a 2-device data mesh, the gradients kept in its optimizer state"""
    settings = dict(SMALL, MESH_SHAPE={'data': 2})
    with pytest.MonkeyPatch.context() as patch:
        for name, value in settings.items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(jax_core, 'build_optimizer', _recording_optimizer())
        mesh = jax_mesh.create_mesh()
        before = jax.device_get(jax_core.create_state(jax.random.PRNGKey(0)))
        step = jax_core.make_train_step(mesh=mesh)
        state, metrics = step(
            jax_mesh.shard_pytree(jax.tree.map(jnp.asarray, before), mesh),
            jax_mesh.shard_batch(_global_batch(0), mesh),
            jax.random.PRNGKey(1))
        after = jax.device_get(state)
    return [before, after], [jax.device_get(metrics)]


def test_create_mesh_without_a_process_group():
    config = _config()
    mesh = parallel.create_mesh(config=config, device='cpu')
    assert (mesh.shape, mesh.rank, mesh.world, mesh.group) == (
        {'data': 1}, 0, 1, False)
    assert mesh.device == torch.device('cpu')
    assert parallel.create_mesh(
        {'data': 1, 'model': 1}, config, 'cpu').axis_names == (
            'data', 'model')
    with pytest.raises(ValueError, match='world'):
        parallel.create_mesh(
            config=config.replace(MESH_SHAPE={'data': 2}), device='cpu')
    # No process group: the gradients pass as they are, nothing is issued
    launches = parallel.all_reduce_mean.launches
    tensors = [torch.ones(3), torch.zeros(2, 2)]
    assert parallel.all_reduce_mean(tensors, mesh) == tensors
    assert parallel.all_reduce_mean.launches == launches


def test_shard_batch_keeps_this_ranks_rows():
    batch = _global_batch(0)
    batch['stems'] = ['a', 'b', 'c', 'd']
    batch['note'] = 'kept'
    for shape, rank, rows in (
        ({'data': 2}, 0, slice(0, 2)),
        ({'data': 2}, 1, slice(2, 4)),
        ({'data': 4}, 3, slice(3, 4)),
        ({'data': 2, 'model': 2}, 1, slice(0, 2)),
        ({'data': 2, 'model': 2}, 2, slice(2, 4)),
        ({'model': 2}, 1, slice(0, 4)),
    ):
        mesh = parallel.Mesh(shape, rank, int(np.prod(list(shape.values()))))
        shard = parallel.shard_batch(batch, mesh)
        for name, value in batch.items():
            if name == 'note':
                assert shard[name] == 'kept'
            else:
                np.testing.assert_array_equal(
                    np.asarray(shard[name]), np.asarray(value[rows]))
    mesh = parallel.Mesh({'data': 2, 'model': 2}, 1, 4)
    assert [str(p) for p in parallel.batch_sharding(mesh)] == ['S(0)', 'R']
    assert [str(p) for p in parallel.replicated_sharding(mesh)] == ['R', 'R']
    with pytest.raises(ValueError, match='divide'):
        parallel.shard_batch(
            {'audio': np.zeros((3, 1))}, parallel.Mesh({'data': 2}, 0, 2))
    whole = parallel.replicate_batch(batch, parallel.Mesh({'data': 2}, 1, 2))
    assert whole['audio'].shape == (4, 1, 2048)


def test_parameter_shardings_match_jax(jax_step):
    """Each JAX leaf is sharded along its trailing axis or replicated; the
    bridge carries a marker of that axis (its index along it) to the
    port's layout, where the port's sharded dim must be the one it runs
    along"""
    params = {
        model: jax_step[0][0][model]['params']
        for model in ('generator', 'discriminator')}
    mesh = jax_mesh.create_mesh({'data': 4, 'model': 2})
    ours_mesh = parallel.Mesh({'data': 4, 'model': 2}, 0, 8)
    state = core.create_state(_config(), 'cpu')
    modules = {'generator': state.generator,
               'discriminator': state.discriminator}
    convert = {
        'generator': lambda tree: bridge.generator_state_dict(
            tree, materialize=False),
        'discriminator': bridge.discriminator_state_dict}
    counts = {}
    for model, tree in params.items():
        specs = jax_mesh.parameter_shardings(tree, mesh, min_size=4)
        sharded = convert[model](jax.tree.map(
            lambda leaf, spec: np.full(
                leaf.shape, float('model' in spec.spec), np.float32),
            tree, specs))
        marker = convert[model](jax.tree.map(
            lambda leaf: np.broadcast_to(
                np.arange(leaf.shape[-1], dtype=np.float32), leaf.shape)
            if leaf.ndim else np.zeros((), np.float32), tree))
        ours = parallel.parameter_shardings(
            modules[model], ours_mesh, min_size=4, parameters=marker)
        assert set(ours) == set(marker)
        for name, value in marker.items():
            expected = None
            if bool(sharded[name].all()):
                varying = [
                    dim for dim in range(value.ndim)
                    if bool((value - value.narrow(dim, 0, 1)).any())]
                assert len(varying) == 1, name
                expected = varying[0]
            else:
                assert not bool(sharded[name].any()), name
            data, model_axis = ours[name]
            assert isinstance(data, torch.distributed.tensor.Replicate)
            got = model_axis.dim if isinstance(
                model_axis, torch.distributed.tensor.Shard) else None
            assert got == expected, (model, name, value.shape)
            counts[expected is None] = counts.get(expected is None, 0) + 1
    # Both kinds occur
    assert counts[False] > 10 and counts[True] > 10

    # A mesh without a 'model' axis replicates everything
    ours = parallel.parameter_shardings(
        state.generator, parallel.Mesh({'data': 8}, 0, 8))
    assert all(isinstance(p, torch.distributed.tensor.Replicate)
               for placements in ours.values() for p in placements)


# One gloo rank, in a process of its own that imports neither JAX nor the
# tests: one step on its half of the batch, its results saved. It inherits
# the test process's thread count through the environment: in float32 a
# Block bias's gradient sums terms that nearly cancel, in an order that
# follows the count (one thread against two moves it by 7e-4 of its scale)
WORKER = """
import sys
import torch
import torch.distributed as dist
import promonet_tpu_torch as port
from promonet_tpu_torch import parallel
from promonet_tpu_torch.train import core

rank, directory = int(sys.argv[1]), sys.argv[2]
given = torch.load(f'{directory}/given.pt', weights_only=False)
dist.init_process_group(
    'gloo', init_method=f'file://{directory}/store', rank=rank, world_size=2)
try:
    config = port.config.load().replace(**given['config'])
    state = core.create_state(config, 'cpu')
    with torch.no_grad():
        for name, value in given['trainable'].items():
            state.trainable[name].copy_(value)
    state.discriminator.load_state_dict(given['discriminator'])
    mesh = parallel.create_mesh(config=config, device='cpu')
    state.mesh = mesh
    gradients = {}
    names, parameters = zip(*state.discriminator.named_parameters())
    for key, optimizer, names, parameters in (
        ('generator', state.generator_optimizer, state.names,
         [state.trainable[name] for name in state.names]),
        ('discriminator', state.discriminator_optimizer, names, parameters)):
        def step(original=optimizer.step, key=key, names=names,
                 parameters=parameters):
            gradients[key] = {
                name: parameter.grad.clone()
                for name, parameter in zip(names, parameters)}
            return original()
        optimizer.step = step
    batch = core.to_device(parallel.shard_batch(given['batch'], mesh), 'cpu')
    metrics = core.average_metrics(core.train_step(state, batch), mesh)
    torch.save({
        'mesh': (mesh.shape, mesh.rank, mesh.world),
        'launches': parallel.all_reduce_mean.launches,
        'trainable': {k: v.detach() for k, v in state.trainable.items()},
        'discriminator': state.discriminator.state_dict(),
        'gradients': gradients,
        'metrics': {k: float(v) for k, v in metrics.items()}},
        f'{directory}/rank{rank}.pt')
finally:
    dist.destroy_process_group()
"""


def test_two_gloo_ranks_step_as_one_process_and_as_jax(jax_step, tmp_path):
    states, metrics = jax_step
    batch = _global_batch(0)
    carried = bridge.train_state(states[0])
    torch.save({
        'config': SMALL, 'batch': batch,
        'trainable': carried['generator']['trainable'],
        'discriminator': carried['discriminator']['params']},
        tmp_path / 'given.pt')
    processes = [
        subprocess.Popen(
            [sys.executable, '-c', WORKER, str(rank), str(tmp_path)],
            cwd=ROOT)
        for rank in (0, 1)]
    try:
        assert [process.wait(timeout=300) for process in processes] == [0, 0]
    finally:
        for process in processes:
            process.kill()
    ranks = [torch.load(tmp_path / f'rank{rank}.pt') for rank in (0, 1)]
    assert [rank['mesh'] for rank in ranks] == [
        ({'data': 2}, 0, 2), ({'data': 2}, 1, 2)]
    # Two gradient buckets and the metrics: three all-reduces
    assert [rank['launches'] for rank in ranks] == [3, 3]

    # Both ranks take the same step
    for part in ('trainable', 'discriminator', 'metrics'):
        for name, value in ranks[0][part].items():
            other = ranks[1][part][name]
            if part == 'metrics':
                assert value == other, name
            else:
                torch.testing.assert_close(other, value, rtol=0, atol=0)

    # As the JAX package's step on its 2-device mesh
    ours = ranks[0]
    done = _port_state(states[0], _config())
    with torch.no_grad():
        for name, value in ours['trainable'].items():
            done.trainable[name].copy_(value)
        done.discriminator.load_state_dict(ours['discriminator'])
    _assert_first_step_matches(
        states, metrics, done, ours['gradients'],
        {name: torch.tensor(value) for name, value in ours['metrics'].items()})

    # As one process's step on the whole batch
    whole = _port_state(states[0], _config())
    gradients = _record_gradients(whole)
    expected = core.train_step(whole, core.to_device(batch, 'cpu'))
    for name, value in expected.items():
        np.testing.assert_allclose(
            ours['metrics'][name], float(value), rtol=1e-5, err_msg=name)
    _assert_gradients_close(ours['gradients'], gradients, _params(states[0]))
    updated = [
        (ours['trainable'][name], whole.trainable[name].detach())
        for name in whole.names] + [
        (ours['discriminator'][name], parameter.detach())
        for name, parameter in whole.discriminator.named_parameters()]
    flips = 0
    for value, reference in updated:
        error = (value - reference).abs()
        assert float(error.max()) <= 2 * LR + 1e-6
        flips += int((error > 1e-6).sum())
    assert flips <= 1e-3 * sum(value.numel() for value, _ in updated)
