"""The port's discriminators held against the JAX package's.

Each family is initialised by the JAX package, carried across by the
bridge, and run on the same numpy-seeded audio (batch 2, 3000 samples,
so each period pads): logits and every feature map (the JAX package's
NHWC maps transposed to NCHW) within 1e-5 relative of their scale, in
float32; and the gradient of a least-squares loss over the logits with
respect to every parameter within 1e-4 of each leaf's largest magnitude,
computed in float64 on both sides (parameters, audio and compute dtype).
In float32 a pre-activation within rounding of zero takes the other
side of a leaky ReLU or ReLU now and then (two of 728,684 in the
complex multi-band maps on this input), which moves the gradient of a
first convolution by up to 1% of its largest value; in float64 no
activation changes side, so the comparison sees the implementation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promonet_tpu.models import discriminator as jax_discriminator

from promonet_tpu_torch.models import bridge, discriminator

SAMPLES = 3000
FAMILIES = {
    'period_7': (
        lambda dtype: jax_discriminator.DiscriminatorP(period=7, dtype=dtype),
        lambda: discriminator.DiscriminatorP(7)),
    'period_11': (
        lambda dtype: jax_discriminator.DiscriminatorP(
            period=11, dtype=dtype),
        lambda: discriminator.DiscriminatorP(11)),
    'complex_multiband': (
        lambda dtype: jax_discriminator.DiscriminatorCMB(dtype=dtype),
        lambda: discriminator.DiscriminatorCMB(1024, 256)),
    'resolution': (
        lambda dtype: jax_discriminator.DiscriminatorR(
            resolution=(512, 50, 240), dtype=dtype),
        lambda: discriminator.DiscriminatorR((512, 50, 240))),
    'scale': (
        lambda dtype: jax_discriminator.DiscriminatorS(dtype=dtype),
        lambda: discriminator.DiscriminatorS()),
    'magnitude_free': (
        lambda dtype: jax_discriminator.DiscriminatorMagFree(
            resolution=(256, 64, 256), dtype=dtype),
        lambda: discriminator.DiscriminatorMagFree((256, 64, 256))),
}

def _audio():
    rng = np.random.default_rng(0)
    return (0.3 * rng.standard_normal((2, 1, SAMPLES))).astype(np.float32)


def _nchw(feature_map, ours):
    """A JAX feature map in the port's layout"""
    feature_map = np.asarray(feature_map)
    return feature_map if ours.dim() == 3 else feature_map.transpose(
        0, 3, 1, 2)


def _state(params):
    """A JAX family's params as the port module's state dict"""
    return {
        name[len('discriminators.0.'):]: value
        for name, value in bridge.discriminator_state_dict(
            {'discriminators_0': params}).items()}


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def family(request):
    """(the port's module carrying the JAX family's float32 params, the
    JAX outputs on one input in float32, and the JAX gradients in
    float64)"""
    make_jax, make_ours = FAMILIES[request.param]
    module = make_jax(jnp.float32)
    audio = _audio()
    params = jax.device_get(
        jax.jit(module.init)(jax.random.PRNGKey(0), audio))
    outputs = jax.device_get(jax.jit(module.apply)(params, audio))
    with jax.enable_x64(True):
        wide = make_jax(jnp.float64)
        wide_params = jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float64), params)

        def loss(params):
            logits, _ = wide.apply(params, audio.astype(np.float64))
            return jnp.mean((1. - logits) ** 2)

        gradients = jax.device_get(jax.jit(jax.grad(loss))(wide_params))
    ours = make_ours()
    ours.load_state_dict(_state(params['params']))
    return ours, outputs, gradients


def test_forward_matches_jax(family):
    ours, (logits, feature_maps), _ = family
    our_logits, our_maps = ours(torch.from_numpy(_audio()), torch.float32)
    expected = np.asarray(logits)
    np.testing.assert_allclose(
        our_logits.detach().numpy(), expected, rtol=0,
        atol=1e-5 * np.abs(expected).max())
    assert len(our_maps) == len(feature_maps)
    for ours_map, theirs in zip(our_maps, feature_maps):
        theirs = _nchw(theirs, ours_map)
        assert ours_map.shape == theirs.shape
        np.testing.assert_allclose(
            ours_map.detach().numpy(), theirs, rtol=0,
            atol=1e-5 * np.abs(theirs).max())


def test_gradients_match_jax(family):
    import copy
    ours, _, gradients = family
    wide = copy.deepcopy(ours).double()
    logits, _ = wide(torch.from_numpy(_audio()).double(), torch.float64)
    torch.mean((1. - logits) ** 2).backward()
    expected = _state(gradients['params'])
    for name, parameter in wide.named_parameters():
        theirs = expected[name].numpy()
        np.testing.assert_allclose(
            parameter.grad.numpy(), theirs, rtol=0,
            atol=1e-4 * np.abs(theirs).max(), err_msg=name)


def test_the_configured_set(tmp_path):
    """The default configuration's set: five periods, then the complex
    multi-band; every family on, in the JAX package's order"""
    import promonet_tpu_torch as port
    config = port.config.load()
    names = [type(d).__name__
             for d in discriminator.Discriminator(config).discriminators]
    assert names == ['DiscriminatorP'] * 5 + ['DiscriminatorCMB']
    every = config.replace(
        MULTI_SCALE_DISCRIMINATOR=True, MULTI_RESOLUTION_DISCRIMINATOR=True,
        FARGAN_DISCRIMINATOR=True)
    names = [type(d).__name__
             for d in discriminator.Discriminator(every).discriminators]
    assert names == (
        ['DiscriminatorP'] * 5 + ['DiscriminatorS'] +
        ['DiscriminatorR'] * 3 + ['DiscriminatorCMB'] +
        ['DiscriminatorMagFree'] * 6)
    assert [d.period for d in discriminator.Discriminator(
        config).discriminators[:5]] == [2, 3, 5, 7, 11]
