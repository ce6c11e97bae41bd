"""FARGAN's training route held against the JAX package's.

The shipped configuration (configs/fargan.py: spectral-convergence loss,
no mel loss, the five period and the complex multi-band discriminators)
at a narrow size: batch 2 of 6 frames (1536 samples), the hop fixed at
256 as FARGAN fixes it, float32, with the adversarial terms on from
step 0 so that the generator's gradient runs through the
discriminators too.

Noise. The training noise cannot match the JAX package's draws, so both
sides get the same uniform values through a shared source: the k-th
draw of a frame (k = 0 .. 43, eleven sites per subframe) takes table k
at the site's shape, on the JAX side through a patch of
`promonet_tpu.models.fargan._additive_noise` (its scan traces one frame,
so a frame's draws are the same in every frame there, and here too).

The step itself is held against the JAX package's in
`test_torch_fargan_step.py`. The training route without noise equals
the inference route exactly: the same operations in the same order.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.models.fargan as jax_fargan
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch.models import fargan
from promonet_tpu_torch.train import core, loss as loss_module


ROOT = Path(__file__).resolve().parent.parent
FRAMES = 6
# The shipped FARGAN configuration, narrowed
NARROW = dict(
    MODEL='fargan', CHUNK_SIZE=FRAMES * 256, BATCH_SIZE=2, REMAT=False,
    PRECISION='float32', MEL_LOSS=False, SPECTRAL_CONVERGENCE_LOSS=True,
    ADVERSARIAL_LOSS_START_STEP=0)
# Noise draws per frame: eleven sites in each of four subframes
PER_FRAME = fargan.NOISE_SITES * 4


def _config(**overrides):
    return port.config.load(ROOT / 'configs' / 'fargan.py').replace(
        **dict(NARROW, **overrides))


def _batch(seed, batch=2, frames=FRAMES):
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


class SharedNoise:
    """The same uniform draws for both packages: draw k of a frame takes
    table k at the site's shape; every draw's shape is recorded"""

    def __init__(self):
        self.shapes = []

    def _table(self, shape):
        k = len(self.shapes) % PER_FRAME
        self.shapes.append(tuple(shape))
        return np.random.default_rng(1000 + k).random(
            shape, dtype=np.float32)

    def __call__(self, x):
        """The port's noise source"""
        return torch.from_numpy(self._table(x.shape)).to(x.dtype)

    def jax(self, x, rng, enabled):
        """`promonet_tpu.models.fargan._additive_noise` with these draws"""
        if not enabled:
            return x
        noise = (1. / 127.) * (jnp.asarray(self._table(x.shape), x.dtype) - .5)
        return jnp.clip(x + noise, -1., 1.)


def _generator(config, seed=0):
    return port.models.init.seeded(port.models.Generator(config), seed)


###############################################################################
# The route
###############################################################################


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_training_route_without_noise_equals_the_inference_route(precision):
    config = _config(PRECISION=precision)
    generator = _generator(config)
    batch = core.to_device(_batch(0), torch.device('cpu'))
    args = core.generator_args(batch, config)
    previous = core.previous_samples_of(batch, config)
    assert previous.shape == (2, 1, 512)
    with torch.no_grad():
        inferred, carry = generator(
            *args, previous_samples=previous, return_states=True)
        trained, trained_carry = generator(
            *args, previous_samples=previous, return_states=True, train=True)
    assert inferred.shape == (2, 1, FRAMES * 256)
    assert torch.equal(trained, inferred)
    assert torch.equal(trained_carry[0], carry[0])
    for ours, theirs in zip(trained_carry[1], carry[1]):
        assert torch.equal(ours, theirs)
    # The training route is one autograd runs back through
    trained = generator(*args, previous_samples=previous, train=True)
    trained.sum().backward()
    assert all(parameter.grad is not None
               for name, parameter in generator.named_parameters()
               if name.startswith('backbone.'))


def test_noise_sites_count_and_order_match_jax(monkeypatch):
    """Eleven draws per subframe on both sides, in the same order, at the
    same shapes; the JAX scan's trace holds one frame of them"""
    config = _config()
    shared = SharedNoise()
    monkeypatch.setattr(jax_fargan, '_additive_noise', shared.jax)
    for name, value in NARROW.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    batch = _batch(0)
    model = promonet_tpu.models.Generator.create()
    params = jax_core.create_state(jax.random.PRNGKey(0))['generator'][
        'params']
    model.apply(
        params, *jax_core.generator_args(batch),
        previous_samples=jax_core.previous_samples_of(batch), train=True,
        rngs={'noise': jax.random.PRNGKey(1)})
    # Flax traces the scan's body more than once: every trace is one
    # frame's draws, in the same order
    traces = len(shared.shapes) // PER_FRAME
    assert traces >= 1 and len(shared.shapes) == traces * PER_FRAME
    theirs = shared.shapes[:PER_FRAME]
    assert shared.shapes == theirs * traces

    shared = SharedNoise()
    generator = _generator(config)
    tensors = core.to_device(batch, torch.device('cpu'))
    with torch.no_grad():
        generator(
            *core.generator_args(tensors, config), train=True, noise=shared,
            previous_samples=core.previous_samples_of(tensors, config))
    assert len(shared.shapes) == FRAMES * PER_FRAME
    for frame in range(FRAMES):
        assert shared.shapes[frame * PER_FRAME:(frame + 1) * PER_FRAME] == \
            theirs
    # The sites of one subframe: conditioning slice, previous subframe,
    # pitch lookback, framewise conv, (GRU state, GLU) x 3, skip tanh
    assert theirs[:fargan.NOISE_SITES] == [
        (2, 128), (2, 64), (2, 68), (2, 256)] + [(2, 256)] * 7


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_noise_lies_within_one_254th_in_the_compute_dtype(dtype):
    generator = torch.Generator().manual_seed(0)
    source = fargan.Uniform(generator)
    zeros = torch.zeros(4096, dtype=dtype)
    noisy = fargan.additive_noise(zeros, source)
    assert noisy.dtype == dtype
    bound = torch.tensor(1. / 254., dtype=dtype).item()
    assert float(noisy.abs().max()) <= bound
    # Both signs, and not a constant
    assert float(noisy.min()) < 0 < float(noisy.max())
    # The extremes of u, and the clip to [-1, 1]
    assert float(fargan.additive_noise(
        zeros[:1], lambda x: torch.zeros_like(x))) == float(
            torch.tensor(-.5 / 127., dtype=dtype) if dtype == torch.float32
            else (1. / 127.) * torch.tensor(-.5, dtype=dtype))
    ones = torch.ones(3, dtype=dtype)
    assert torch.equal(
        fargan.additive_noise(ones, lambda x: torch.full_like(x, .99)), ones)
    assert torch.equal(
        fargan.additive_noise(-ones, lambda x: torch.zeros_like(x)), -ones)
    # A seeded source draws the same values again
    again = fargan.additive_noise(
        zeros, fargan.Uniform(torch.Generator().manual_seed(0)))
    assert torch.equal(noisy, again)


###############################################################################
# The step
###############################################################################


def test_the_losses_see_the_given_history(monkeypatch):
    """The first HOPSIZE * FARGAN_PREVIOUS_FRAMES samples of what the
    losses and discriminators see are the batch's own audio; the rest is
    the generator's, from that history"""
    config = _config()
    seen = []
    original = loss_module.multi_resolution_spectral_convergence

    def spy(generated, audio):
        seen.append(generated.detach().clone())
        return original(generated, audio)

    monkeypatch.setattr(
        loss_module, 'multi_resolution_spectral_convergence', spy)
    state = core.create_state(config, 'cpu')
    batch = core.to_device(_batch(1), torch.device('cpu'))
    with torch.no_grad():
        expected = state.generator(
            *core.generator_args(batch, config), train=True,
            previous_samples=batch['audio'][..., :512],
            noise=fargan.Uniform(torch.Generator().manual_seed(
                config.RANDOM_SEED + 1)))
    core.train_step(state, batch)
    assert torch.equal(seen[0][..., :512], batch['audio'][..., :512])
    assert torch.equal(seen[0][..., 512:], expected[..., 512:])
    # The step's noise stream goes on: a second step draws other values
    assert not torch.equal(
        fargan.Uniform(state.rng)(torch.zeros(8)),
        fargan.Uniform(torch.Generator().manual_seed(
            config.RANDOM_SEED + 1))(torch.zeros(8)))
