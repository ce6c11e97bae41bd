"""The bridge against the repo's real checkpoints.

Under the `runs/promonet/synthetic.py` configuration on both sides (24
speakers, the synthetic corpus's pitch-bin statistics), the release
generator and the shipped pitch and PPG checkpoints are restored on the
CPU with the JAX package's own loader, carried over, and every leaf must
map onto a port parameter of the same shape with none left over. Then
the models run in float32 on both sides at full width.
"""
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg
from promonet_tpu.utils import checkpoint

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

CONFIG = 'runs/promonet/synthetic.py'
GENERATOR = 'runs/promonet/release/generator-00155000'
PITCH = 'promonet_tpu/assets/checkpoints/pitch'
PPG = 'promonet_tpu/assets/checkpoints/ppg'


@pytest.fixture
def synthetic(monkeypatch):
    """The synthetic run's configuration, applied to both packages"""
    spec = importlib.util.spec_from_file_location('synthetic', CONFIG)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = port.config.load(CONFIG)
    for name in dir(module):
        if name.isupper() and name != 'MODULE':
            monkeypatch.setattr(promonet_tpu, name, getattr(module, name))
    monkeypatch.setattr(promonet_tpu, 'NUM_SPEAKERS', config.NUM_SPEAKERS)
    return config


@pytest.fixture(scope='module')
def generator_params():
    return jax.device_get(checkpoint.load(GENERATOR)['params'])


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_release_checkpoints_map_every_leaf(synthetic, generator_params):
    assert synthetic.NUM_SPEAKERS == 24
    generator = port.models.Generator(synthetic)
    state = bridge.generator_state_dict(generator_params)
    generator.load_state_dict(state, strict=True)
    # Weight norm folds (v, g) into one weight: each of the twelve
    # blocks turns 6 * 3 leaves into 2 tensors, each of the four
    # transposed convs 3 leaves into 2
    assert _leaf_count(generator_params) == \
        len(state) + 12 * (6 * 3 - 2) + 4 * (3 - 2)
    for name, path in (('pitch', PITCH), ('ppg', PPG)):
        params = jax.device_get(checkpoint.load(path)['params'])
        model = (port.preprocess.PitchCNN() if name == 'pitch'
                 else port.preprocess.PPGEncoder())
        state = getattr(bridge, f'{name}_state_dict')(params)
        model.load_state_dict(state, strict=True)
        assert _leaf_count(params) == len(state)


def test_release_pitch_and_ppg_match_jax():
    frames = np.random.default_rng(0).standard_normal(
        (4, 1024)).astype(np.float32)
    model = port.preprocess.PitchCNN()
    params = jax.device_get(checkpoint.load(PITCH)['params'])
    model.load_state_dict(bridge.pitch_state_dict(params))
    theirs = np.asarray(jax_pitch.PitchCNN.Model().apply(
        params, jnp.asarray(frames)))
    with torch.no_grad():
        ours = model(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())

    mels = np.random.default_rng(1).standard_normal(
        (1, 40, 80)).astype(np.float32) - 4
    model = port.preprocess.PPGEncoder()
    params = jax.device_get(checkpoint.load(PPG)['params'])
    model.load_state_dict(bridge.ppg_state_dict(params))
    theirs = np.asarray(jax_ppg.PPGEncoder(num_phonemes=40).apply(
        params, jnp.asarray(mels)))
    with torch.no_grad():
        ours = model(torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


def test_release_generator_matches_jax(synthetic, generator_params):
    """Full-width float32 forward on 64 frames"""
    frames = 64
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((1, 40, frames)) * 2
    inputs = (
        rng.uniform(-100, 20, (1, 513, frames)).astype(np.float32),
        rng.uniform(80, 300, (1, frames)).astype(np.float32),
        rng.uniform(0, 1, (1, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
            np.float32),
        np.array([3], np.int32),
        np.ones(1, np.float32),
        np.ones(1, np.float32))
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    theirs = np.asarray(jax.jit(jax_model.apply)(
        generator_params, *map(jnp.asarray, inputs)))

    generator = port.models.Generator(synthetic.replace(PRECISION='float32'))
    generator.load_state_dict(bridge.generator_state_dict(generator_params))
    with torch.no_grad():
        ours = generator(
            *map(torch.from_numpy, inputs[:4]),
            torch.from_numpy(inputs[4]).long(),
            *map(torch.from_numpy, inputs[5:])).numpy()
    assert ours.shape == theirs.shape == (1, 1, frames * 256)
    np.testing.assert_allclose(
        ours, theirs, rtol=0, atol=1e-4 * np.abs(theirs).max())
