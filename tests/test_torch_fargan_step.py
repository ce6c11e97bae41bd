"""One FARGAN training step held against the JAX package's.

The narrow configuration, the shared noise and the tolerances of
`test_torch_fargan_train.py`: one float32 step from the JAX package's
`create_state`, carried across by the bridge, every loss within 1e-5
relative, every generator gradient leaf within 1e-4 of its largest
magnitude and the discriminators' within 2e-2 (the HiFi-GAN step's
tolerances, `test_torch_train.py`). The JAX step's compile is most of
this file's time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.models.fargan as jax_fargan
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch.train import core

from test_torch_fargan_train import (
    FRAMES, NARROW, PER_FRAME, SharedNoise, _batch, _config)
from test_torch_train import (
    _assert_gradients_close, _jax_gradients, _params, _port_state,
    _record_gradients, _recording_optimizer)


@pytest.fixture(scope='module')
def jax_step():
    """The JAX trainer's state before and after one step with the shared
    noise, its metrics, and the noise's draws"""
    shared = SharedNoise()
    with pytest.MonkeyPatch.context() as patch:
        for name, value in NARROW.items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(jax_core, 'build_optimizer', _recording_optimizer())
        patch.setattr(jax_fargan, '_additive_noise', shared.jax)
        before = jax.device_get(jax_core.create_state(jax.random.PRNGKey(0)))
        state, metrics = jax_core.make_train_step()(
            jax.tree.map(jnp.asarray, before), _batch(0),
            jax.random.PRNGKey(1))
        after = jax.device_get(state)
    return before, after, jax.device_get(metrics), shared.shapes


def test_first_step_matches_jax(jax_step):
    before, after, theirs, jax_shapes = jax_step
    config = _config()
    state = _port_state(before, config)
    gradients = _record_gradients(state)
    shared = SharedNoise()
    ours = core.train_step(
        state, core.to_device(_batch(0), torch.device('cpu')), noise=shared)
    assert len(shared.shapes) == FRAMES * PER_FRAME
    assert shared.shapes[:PER_FRAME] == jax_shapes[:PER_FRAME]
    assert set(ours) == set(theirs)
    assert 'loss/generator/spectral-convergence' in ours and \
        'loss/generator/mels' not in ours
    for name, value in theirs.items():
        if name.startswith('gradients/'):
            continue
        np.testing.assert_allclose(
            float(ours[name]), float(value), rtol=1e-5, err_msg=name)
    _assert_gradients_close(gradients, _jax_gradients(after), _params(before))


def test_train_state_carries_every_fargan_leaf(jax_step):
    """The bridge's trainable set: (v, g) of every weight-normed Dense, the
    plain Dense and GRU weights, the speaker and pitch tables"""
    before, _, _, _ = jax_step
    carried = port.models.bridge.train_state(before)['generator']
    ours = core.create_state(_config(), 'cpu')
    assert set(carried['trainable']) == set(ours.trainable)
    normed = sorted(name for name in ours.trainable if name.endswith('_v'))
    assert normed == sorted(
        f'backbone.subframe.{name}.weight_v' for name in (
            'fwconv.dense', 'fwconv.glu.dense', 'glus.0.dense',
            'glus.1.dense', 'glus.2.dense', 'skip_glu.dense'))
    leaves = sum(np.size(leaf) for leaf in jax.tree_util.tree_leaves(
        before['generator']['params']))
    assert leaves == sum(
        value.numel() for value in carried['trainable'].values())
    for name, value in carried['trainable'].items():
        assert value.shape == ours.trainable[name].shape, name
