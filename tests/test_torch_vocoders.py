"""The port's FARGAN and Vocos backbones held against the JAX package's.

Every parameter leaf is perturbed with seeded noise before the bridge
carries it over, so a mis-mapped leaf shows. Float32 throughout.
Tolerances: the existing one of `test_torch_models.py` (rtol 1e-4, atol
1e-4 of the largest reference value) for everything without feedback;
FARGAN's audio feeds back into itself sample by sample, so a float32
sum-order difference grows along the signal, and the whole backbone is
held to the JAX package's own streaming contract
(`tests/test_pipeline.py::test_fargan_streaming_exact`): the first four
frames within 1e-5, the whole within 2e-3, correlation above 0.9999.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.models import fargan as jax_fargan
from promonet_tpu.models import modules as jax_modules
from promonet_tpu.ops import stft as jax_stft

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge, fargan
from promonet_tpu_torch.models.modules import Dense
from promonet_tpu_torch.ops import stft

HOPSIZE = 256


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32) +
        scale * rng.standard_normal(np.shape(leaf)).astype(np.float32),
        jax.device_get(params))


def _assert_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


def _assert_fargan_contract(ours, theirs):
    """First four frames within 1e-5, all within 2e-3, correlation > 0.9999"""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    difference = np.abs(ours - theirs)
    assert difference[..., :4 * HOPSIZE].max() < 1e-5
    assert difference.max() < 2e-3
    correlation = float((ours * theirs).sum()) / float(
        np.linalg.norm(ours) * np.linalg.norm(theirs))
    assert correlation > 0.9999


def _leaves(params):
    return bridge._Leaves(params)


def _states(rng, batch):
    return tuple(
        (0.5 * rng.standard_normal((batch, width))).astype(np.float32)
        for width in (256, 256, 256, 260))


###############################################################################
# FARGAN's parts
###############################################################################


def test_wn_dense_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 7, 20)).astype(
        np.float32)
    module = jax_modules.WNDense(12)
    params = _perturbed(module.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ours = port.models.modules.Dense(20, 12)
    leaves = params['params']
    ours.load_state_dict({'weight': torch.from_numpy(np.ascontiguousarray(
        bridge.weight_norm(leaves['kernel_v'], leaves['kernel_g'], (0,)).T))})
    with torch.no_grad():
        _assert_close(ours(torch.from_numpy(x)).numpy(),
                      module.apply(params, jnp.asarray(x)))


def test_gru_cell_matches_jax():
    """Gate order r, z, n and the input projection's -1/sqrt(H) offset"""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 384)).astype(np.float32)
    state = (0.5 * rng.standard_normal((4, 256))).astype(np.float32)
    module = jax_fargan.GRUCellNoBias(256)
    params = _perturbed(module.init(
        jax.random.PRNGKey(1), jnp.asarray(state), jnp.asarray(x)), 3)
    theirs = module.apply(params, jnp.asarray(state), jnp.asarray(x))
    ours = fargan.GRUCellNoBias(384, 256)
    leaves = _leaves(params)
    ours.load_state_dict(leaves.finish({
        'weight_ih': bridge._dense(leaves, 'Dense_0'),
        'weight_hh': bridge._dense(leaves, 'Dense_1')}))
    with torch.no_grad():
        _assert_close(
            ours(torch.from_numpy(state), torch.from_numpy(x)).numpy(),
            theirs)
        # Without the offset the cell is another function
        ours.bias_ih.zero_()
        assert not np.allclose(
            ours(torch.from_numpy(state), torch.from_numpy(x)).numpy(),
            theirs, atol=1e-3)


def test_framewise_conv_and_glu_match_jax():
    rng = np.random.default_rng(4)
    features = rng.standard_normal((2, 260)).astype(np.float32)
    state = rng.standard_normal((2, 260)).astype(np.float32)
    module = jax_fargan.FramewiseConv(256)
    params = _perturbed(module.init(
        jax.random.PRNGKey(2), jnp.asarray(features), jnp.asarray(state)), 5)
    leaves = _leaves(params)
    ours = fargan.FramewiseConv(260, 256)
    ours.load_state_dict(leaves.finish({
        'dense.weight': bridge._wn_dense(leaves, 'WNDense_0'),
        'glu.dense.weight': bridge._wn_dense(leaves, 'GLU_0/WNDense_0')}))
    with torch.no_grad():
        _assert_close(
            ours(torch.from_numpy(features), torch.from_numpy(state)).numpy(),
            module.apply(params, jnp.asarray(features), jnp.asarray(state)))


def test_conditioning_network_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 9, 30)).astype(
        np.float32)
    module = jax_fargan.ConditioningNetwork(HOPSIZE)
    params = _perturbed(module.init(jax.random.PRNGKey(3), jnp.asarray(x)), 7)
    leaves = _leaves(params)
    ours = fargan.ConditioningNetwork(30, HOPSIZE)
    ours.load_state_dict(leaves.finish({
        f'layers.{i}.weight': bridge._dense(leaves, f'Dense_{i}')
        for i in range(3)}))
    with torch.no_grad():
        _assert_close(ours(torch.from_numpy(x)).numpy(),
                      module.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize('periods', [(1, 446), (64, 65), (200, 30)])
def test_subframe_network_matches_jax(periods):
    """One subframe from a sample history and a pitch period: the
    lookback reads one period back, or two where one would run past the
    history's end (periods below the subframe's length)"""
    rng = np.random.default_rng(periods[0])
    features = rng.standard_normal((2, 128)).astype(np.float32)
    history = (0.3 * rng.standard_normal((2, 512))).astype(np.float32)
    period = np.asarray(periods, np.int32)
    states = _states(rng, 2)
    module = jax_fargan.SubframeNetwork(256, 64, 512, True, False)
    args = (jnp.asarray(features), jnp.asarray(history), jnp.asarray(period),
            tuple(map(jnp.asarray, states)), None)
    params = _perturbed(module.init(jax.random.PRNGKey(4), *args), 8)
    theirs, their_states = module.apply(params, *args)

    tree = {'backbone': {
        'ConditioningNetwork_0': {
            f'Dense_{i}': {'kernel': np.zeros((1, 1), np.float32)}
            for i in range(3)},
        'ScanFrameStep_0': {'SubframeNetwork_0': params['params']}},
        'speaker_embedding': {'embedding': np.zeros((1, 1), np.float32)}}
    state = bridge.generator_state_dict(tree)
    ours = fargan.SubframeNetwork(256, 64)
    ours.load_state_dict({
        name[len('backbone.subframe.'):]: value
        for name, value in state.items()
        if name.startswith('backbone.subframe.')})
    samples = torch.from_numpy(history)
    index = fargan.lookback_index(torch.from_numpy(period).long(), 512, 64)
    with torch.no_grad():
        output, our_states = ours(
            torch.from_numpy(features), torch.gather(samples, 1, index),
            samples[:, -64:], tuple(map(torch.from_numpy, states)))
    _assert_close(output.numpy(), theirs)
    for a, b in zip(our_states, their_states):
        _assert_close(a.numpy(), b)


###############################################################################
# Whole backbones
###############################################################################


def _fargan_problem(frames=24, seed=9):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((2, frames, 13)).astype(np.float32)
    # Periods of 40 to 500 Hz pitch at 22050 Hz, clipped by the backbone
    features[..., -1] = rng.uniform(22050 / 500, 22050 / 40, (2, frames))
    global_features = rng.standard_normal((2, 1, 6)).astype(np.float32)
    module = jax_fargan.FARGAN()
    params = _perturbed(module.init(
        jax.random.PRNGKey(5), jnp.asarray(features),
        jnp.asarray(global_features)), 10)
    tree = {'backbone': params['params'],
            'speaker_embedding': {'embedding': np.zeros((1, 1), np.float32)}}
    ours = fargan.FARGAN(13, 6)
    ours.load_state_dict({
        name[len('backbone.'):]: value
        for name, value in bridge.generator_state_dict(tree).items()
        if name.startswith('backbone.')})
    return module, params, ours, features, global_features


def test_fargan_matches_jax():
    module, params, ours, features, global_features = _fargan_problem()
    theirs, (their_history, their_states) = module.apply(
        params, jnp.asarray(features), jnp.asarray(global_features),
        return_states=True)
    with torch.no_grad():
        audio, (history, states) = ours(
            torch.from_numpy(features), torch.from_numpy(global_features),
            return_states=True)
    assert audio.shape == (2, 24 * HOPSIZE, 1) and audio.dtype == torch.float32
    _assert_fargan_contract(audio.numpy(), theirs)
    np.testing.assert_allclose(
        history.numpy(), their_history, rtol=0, atol=2e-3)
    for a, b in zip(states, their_states):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2)


def test_fargan_continues_from_its_carry():
    """Two calls, the second from the first's carry, against the JAX
    package's one pass, and against the port's one pass"""
    module, params, ours, features, global_features = _fargan_problem()
    theirs = module.apply(
        params, jnp.asarray(features), jnp.asarray(global_features))
    with torch.no_grad():
        whole = ours(
            torch.from_numpy(features), torch.from_numpy(global_features))
        first, carry = ours(
            torch.from_numpy(features[:, :10]),
            torch.from_numpy(global_features), return_states=True)
        second = ours(
            torch.from_numpy(features[:, 10:]),
            torch.from_numpy(global_features), initial_states=carry)
    chunked = torch.cat((first, second), 1).numpy()
    _assert_fargan_contract(chunked, theirs)
    _assert_fargan_contract(chunked, whole.numpy())


def _generator_inputs(seed, batch, frames):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((batch, 40, frames)) * 2
    return (
        rng.uniform(-100, 20, (batch, 513, frames)).astype(np.float32),
        rng.uniform(40, 600, (batch, frames)).astype(np.float32),
        rng.uniform(0, 1, (batch, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
            np.float32),
        np.array([3, 1][:batch], np.int32),
        np.array([1., 0.8][:batch], np.float32),
        np.array([1., 1.2][:batch], np.float32))


def _as_torch(inputs):
    return [torch.from_numpy(x).long() if x.dtype == np.int32
            else torch.from_numpy(x) for x in inputs]


def _generators(monkeypatch, model, **overrides):
    """The JAX package's and the port's generator for `model`, float32,
    with the same perturbed weights"""
    monkeypatch.setattr(promonet_tpu, 'MODEL', model)
    for name, value in overrides.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    inputs = _generator_inputs(11, 2, 16)
    params = _perturbed(jax.jit(jax_model.init)(
        jax.random.PRNGKey(6), *map(jnp.asarray, inputs)), 12)
    config = port.config.load().replace(
        MODEL=model, PRECISION='float32', **overrides)
    generator = port.models.Generator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    return jax_model, params, generator


def test_fargan_generator_matches_jax(monkeypatch):
    """Feature preparation appends SAMPLE_RATE / clip(pitch) for FARGAN"""
    jax_model, params, generator = _generators(monkeypatch, 'fargan')
    inputs = _generator_inputs(13, 2, 20)
    theirs = jax_model.apply(
        params, *map(jnp.asarray, inputs[:4]),
        method=jax_model.prepare_features)
    with torch.no_grad():
        ours = generator.prepare_features(*_as_torch(inputs[:4]))
    assert ours.shape[-1] == port.config.load().NUM_FEATURES + 1
    _assert_close(ours.numpy(), theirs)
    theirs = jax.jit(jax_model.apply)(params, *map(jnp.asarray, inputs))
    with torch.no_grad():
        audio = generator(*_as_torch(inputs))
    assert audio.shape == (2, 1, 20 * HOPSIZE)
    _assert_fargan_contract(audio.numpy(), theirs)


def test_vocos_generator_matches_jax(monkeypatch):
    """Vocos at narrow width: 64 channels, 128 pointwise, 2 layers"""
    jax_model, params, generator = _generators(
        monkeypatch, 'vocos', VOCOS_CHANNELS=64, VOCOS_POINTWISE_CHANNELS=128,
        VOCOS_LAYERS=2)
    inputs = _generator_inputs(14, 2, 20)
    theirs = jax.jit(jax_model.apply)(params, *map(jnp.asarray, inputs))
    with torch.no_grad():
        audio = generator(*_as_torch(inputs))
    assert audio.shape == (2, 1, 20 * HOPSIZE) and audio.dtype == torch.float32
    _assert_close(audio.numpy(), theirs)


@pytest.mark.parametrize('frames', [1, 3, 17])
def test_istft_matches_jax(frames):
    rng = np.random.default_rng(frames)
    spec = (rng.standard_normal((2, 513, frames)) +
            1j * rng.standard_normal((2, 513, frames))).astype(np.complex64)
    window = np.asarray(jax_stft.hann_window(1024))
    theirs = np.asarray(jax_stft.istft(jnp.asarray(spec), 1024, 256, window))
    ours = stft.istft(
        torch.from_numpy(spec), 1024, 256, stft.hann_window(1024)).numpy()
    assert ours.shape == theirs.shape == (2, frames * 256)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    frames_in = rng.standard_normal((3, 8, frames)).astype(np.float32)
    np.testing.assert_allclose(
        stft.overlap_add(torch.from_numpy(frames_in), 3).numpy(),
        np.asarray(jax_stft.overlap_add(jnp.asarray(frames_in), 3)),
        rtol=0, atol=1e-6)


###############################################################################
# The bridge, the configuration and the seeded weights
###############################################################################


@pytest.mark.parametrize('model,overrides', [
    ('fargan', {}),
    ('vocos', dict(VOCOS_CHANNELS=32, VOCOS_POINTWISE_CHANNELS=48,
                   VOCOS_LAYERS=3))])
def test_bridge_uses_every_leaf_of_the_backbone(monkeypatch, model, overrides):
    jax_model, params, generator = _generators(monkeypatch, model, **overrides)
    # Every leaf taken (else the bridge raises), every parameter given
    state = bridge.generator_state_dict(params)
    assert set(state) == set(generator.state_dict())
    backbone = jax.device_get(params)['params']['backbone']
    first = sorted(backbone)[0]
    extra = jax.tree_util.tree_map(lambda x: x, jax.device_get(params))
    extra['params']['backbone']['Extra_0'] = {'kernel': np.zeros(2)}
    with pytest.raises(ValueError, match='Extra_0'):
        bridge.generator_state_dict(extra)
    missing = jax.tree_util.tree_map(lambda x: x, jax.device_get(params))
    del missing['params']['backbone'][first]
    with pytest.raises(KeyError):
        bridge.generator_state_dict(missing)


def test_generator_refuses_what_is_not_ported():
    config = port.config.load()
    # The JAX generator does not build CARGAN either (models.cargan does)
    with pytest.raises(ValueError, match='Generator model cargan is not'):
        port.models.Generator(config.replace(MODEL='cargan'))
    # A spectrogram-only configuration is MelGenerator's
    mels = config.replace(SPECTROGRAM_ONLY=True, HIFIGAN_UPSAMPLE_INITIAL_SIZE=16)
    with pytest.raises(ValueError, match='MelGenerator'):
        port.models.Generator(mels)
    assert isinstance(
        port.load.generator(config=mels, device='cpu'),
        port.models.MelGenerator)
    with pytest.raises(ValueError, match='world'):
        port.models.Generator(config.replace(MODEL='world'))
    # Zero-shot speakers are ported: a Dense over x-vectors
    generator = port.models.Generator(config.replace(
        ZERO_SHOT=True, HIFIGAN_UPSAMPLE_INITIAL_SIZE=16))
    assert isinstance(generator.speaker_embedding, Dense)


@pytest.mark.parametrize('model,expected', [
    ('hifigan', 1), ('vocos', 1), ('fargan', 2 * HOPSIZE),
    ('cargan', 2 * HOPSIZE)])
def test_num_previous_samples_follows_the_model(model, expected):
    config = port.config.load().replace(MODEL=model)
    assert config.NUM_PREVIOUS_SAMPLES == expected
    assert port.config.load().replace(
        MODEL=model, FARGAN_PREVIOUS_FRAMES=3, CARGAN_INPUT_SIZE=100
    ).NUM_PREVIOUS_SAMPLES == {
        'fargan': 3 * HOPSIZE, 'cargan': 100}.get(model, 1)
    if model == 'fargan':
        # FARGAN's sample history is as wide as the streamer's carry
        assert port.models.Generator(config.replace(
            FARGAN_PREVIOUS_FRAMES=3)).backbone.num_previous == 3 * HOPSIZE


@pytest.mark.parametrize('path', ['configs/fargan.py',
                                  'configs/baselines/vocos.py'])
def test_seeded_backbones_are_finite(path):
    """Every parameter is drawn or set: none is left uninitialised"""
    config = port.config.load(path).replace(
        PRECISION='float32', VOCOS_CHANNELS=32, VOCOS_POINTWISE_CHANNELS=48)
    generator = port.models.init.seeded(port.models.Generator(config), 0)
    for name, parameter in generator.named_parameters():
        assert torch.isfinite(parameter).all(), name
    for module in generator.modules():
        if isinstance(module, fargan.GRUCellNoBias):
            for weight in (module.weight_ih, module.weight_hh):
                assert 0 <= weight.min() and weight.max() <= 2 / 16
    inputs = _as_torch(_generator_inputs(15, 1, 6))
    with torch.no_grad():
        audio = generator(*inputs)
    assert audio.shape == (1, 1, 6 * HOPSIZE)
    assert torch.isfinite(audio).all()


def test_dense_casts_its_weight_once():
    layer = Dense(4, 3)
    torch.nn.init.normal_(layer.weight)
    x = torch.ones(2, 4)
    with torch.no_grad():
        first = layer(x, torch.bfloat16)
        assert layer(x, torch.bfloat16).dtype == torch.bfloat16
        cached = layer._casts['weight'][1]
        layer(x, torch.bfloat16)
        assert layer._casts['weight'][1] is cached
        layer.weight.mul_(2.)
        again = layer(x, torch.bfloat16)
    assert layer._casts['weight'][1] is not cached
    torch.testing.assert_close(again, 2 * first)


###############################################################################
# FARGAN's inference loop: the plain route, and K4's route in slots
# (`ops.fargan.Slots`) with a stand-in for the kernel
###############################################################################


def _subframe_loop(backbone, features, global_features, dtype,
                   initial_states=None):
    """The inference loop before K4: one sample buffer, each subframe's
    lookback gathered from it and cast, the subframe called without
    slots"""
    batch, frames, _ = features.shape
    size, history = backbone.subframe_size, backbone.num_previous
    period = torch.clamp(
        torch.round(features[..., -1]).long(), 1, history - size - 2)
    cond = backbone.conditioning(torch.cat((
        features[..., :-1], global_features.expand(batch, frames, -1)), -1),
        dtype)
    cond = cond.reshape(batch, frames, 2 * size, backbone.subframes)
    cond = cond.transpose(2, 3).contiguous()
    lookback = fargan.lookback_index(period, history, size)
    if initial_states is None:
        initial_states = backbone.initial_states(batch, dtype, features.device)
    previous, states = initial_states
    samples = torch.empty((batch, history + frames * backbone.hopsize))
    samples[:, :history] = previous
    for frame in range(frames):
        index = lookback[:, frame]
        for subframe in range(backbone.subframes):
            start = (frame * backbone.subframes + subframe) * size
            window = samples[:, start:start + history]
            output, states = backbone.subframe(
                cond[:, frame, subframe],
                torch.gather(window, 1, index).to(dtype),
                window[:, -size:].to(dtype), states, dtype)
            samples[:, start + history:start + history + size] = output
    return samples[:, history:, None], (samples[:, -history:], states)


def _fargan_inputs(batch, frames, seed):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((batch, frames, 13)).astype(np.float32)
    # Periods from below a subframe (two periods back) to the longest
    features[..., -1] = rng.uniform(20., 450., (batch, frames))
    global_features = rng.standard_normal((batch, 1, 6)).astype(np.float32)
    return torch.from_numpy(features), torch.from_numpy(global_features)


def _stand_in_for_k4(monkeypatch):
    """Let the CPU take K4's route, with the plain subframe in the kernel's
    place writing what one launch writes: the output and the new states
    into their slots, the samples into the history and the next
    subframe's lookback and previous subframe into theirs. Returns the
    steps it ran"""
    from promonet_tpu_torch.ops import fargan as kernel
    launched = []

    def launch(network, features, lookback, previous, states, slots, step):
        own = slots.step(step)
        assert all(a is b for a, b in zip(
            (features, lookback, previous, states), own))
        output, new_states = network.plain(
            features, lookback, previous, states, torch.bfloat16, None)
        own[4].copy_(output)
        for slot, state in zip(own[5], new_states):
            slot.copy_(state)
        start = slots.history + step * slots.size
        slots.samples[:, start:start + slots.size] = own[4]
        if step + 1 < slots.count:
            slots.feed(step + 1)
        launched.append(step)
        launch.launches += 1
        return own[4], own[5]

    launch.launches = 0
    monkeypatch.setattr(kernel, 'KERNEL_DEVICES', ('cpu',))
    monkeypatch.setattr(kernel, 'subframe', launch)
    return launched


ROUTES = [('plain', torch.bfloat16), ('plain', torch.float32),
          ('slots', torch.bfloat16)]


@pytest.mark.parametrize('route,dtype', ROUTES,
                         ids=['plain-bf16', 'plain-float32', 'slots-bf16'])
@pytest.mark.parametrize('carried', [False, True], ids=['zeros', 'carry'])
@pytest.mark.parametrize('batch', [1, 3])
def test_slot_loop_is_the_subframe_loop(monkeypatch, batch, carried, route,
                                        dtype):
    """Either route of the inference loop gives, bit for bit, the audio
    and the carry of the loop before K4, from zeros and from a carried
    state"""
    torch.manual_seed(batch)
    backbone = port.models.init.seeded(fargan.FARGAN(13, 6), 11).eval()
    features, global_features = _fargan_inputs(batch, 5, 20 + batch)
    initial = None
    with torch.no_grad():
        if carried:
            _, initial = backbone(
                *_fargan_inputs(batch, 3, 40 + batch), dtype,
                return_states=True)
        old, (old_history, old_states) = _subframe_loop(
            backbone, features, global_features, dtype, initial)
        launched = (_stand_in_for_k4(monkeypatch) if route == 'slots'
                    else [])
        audio, (history, states) = backbone(
            features, global_features, dtype, initial_states=initial,
            return_states=True)
    assert launched == (list(range(5 * backbone.subframes))
                        if route == 'slots' else [])
    assert torch.equal(audio, old)
    assert torch.equal(history, old_history)
    for state, old_state in zip(states, old_states):
        assert state.dtype == dtype and torch.equal(state, old_state)


@pytest.mark.parametrize('route', ['plain', 'slots'])
@pytest.mark.parametrize('batch', [1, 3])
def test_subframe_hook_sees_each_call_and_keeps_what_it_saw(
        monkeypatch, batch, route):
    """A forward hook on the subframe sees one call a subframe, and the
    tensors each call received and returned are its own and are never
    written again (the benchmark's check keeps them)"""
    backbone = port.models.init.seeded(fargan.FARGAN(13, 6), 12).eval()
    features, global_features = _fargan_inputs(batch, 4, 30 + batch)
    if route == 'slots':
        _stand_in_for_k4(monkeypatch)
    kept = []

    def hook(module, arguments, output):
        tensors = [*arguments[:3], *arguments[3], output[0], *output[1]]
        kept.append((tensors, [tensor.clone() for tensor in tensors]))

    handle = backbone.subframe.register_forward_hook(hook)
    try:
        with torch.no_grad():
            audio = backbone(features, global_features, torch.bfloat16)
    finally:
        handle.remove()
    assert len(kept) == 4 * backbone.subframes
    for tensors, copies in kept:
        for tensor, copy in zip(tensors, copies):
            assert torch.equal(tensor, copy)
    # Each call's arguments and outputs lie apart from every other call's,
    # except the states a call returns, which the next call receives
    regions = {}
    for call, (tensors, _) in enumerate(kept):
        for position, tensor in enumerate(tensors):
            if position in (3, 4, 5, 6) and call:
                continue
            start = tensor.data_ptr()
            end = start + tensor.numel() * tensor.element_size()
            assert (start, end) not in regions
            regions[(start, end)] = (call, position)
    for call in range(1, len(kept)):
        assert all(a is b for a, b in zip(
            kept[call][0][3:7], kept[call - 1][0][8:12]))
    outputs = torch.cat([tensors[7] for tensors, _ in kept], -1)
    assert torch.equal(outputs.float(), audio[..., 0])


@pytest.mark.parametrize('route', ['plain', 'slots'])
def test_frame_loop_span_counts_subframes_and_fused_ones(monkeypatch, route):
    """The loop is the span `frame_loop` inside `vocoder`; `fused` counts
    the subframes K4 ran, from its launches: none on the plain route"""
    config = port.config.load('configs/fargan.py')
    generator = port.models.init.seeded(
        port.models.Generator(config), 3).eval()
    inputs = _as_torch(_generator_inputs(16, 2, 5))
    if route == 'slots':
        _stand_in_for_k4(monkeypatch)
    timer = port.utils.timer
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        timer.reset()
        generator(*inputs)
        spans = timer.spans()
    loops = [span for span in spans if span.name == 'frame_loop']
    assert len(loops) == 1
    parent = next(span for span in spans if span.id == loops[0].parent)
    assert parent.name == 'vocoder'
    subframes = 2 * 5 * 4
    assert loops[0].counts == {
        'subframes': subframes, 'rows': 2,
        'fused': subframes if route == 'slots' else 0}


def test_subframe_route_follows_device_dtype_grad_and_noise(monkeypatch):
    """K4 takes CUDA bf16 subframes without autograd or noise, decided
    from those alone: here the CPU stands in for the card and the plain
    subframe for the launch"""
    from promonet_tpu_torch.ops import fargan as kernel
    launched = _stand_in_for_k4(monkeypatch)
    backbone = port.models.init.seeded(fargan.FARGAN(13, 6), 13).eval()
    features, global_features = _fargan_inputs(1, 2, 7)
    # Inference in bf16 without autograd: every subframe
    with torch.no_grad():
        backbone(features, global_features, torch.bfloat16)
    assert launched == list(range(8))
    launched.clear()
    # float32, autograd on, and the training route: none
    with torch.no_grad():
        backbone(features, global_features, torch.float32)
    backbone(features, global_features, torch.bfloat16)
    backbone(features, global_features, torch.bfloat16, train=True)
    assert launched == []
    # Training noise: never
    x = torch.zeros(1)
    with torch.no_grad():
        assert kernel.uses_kernel(x, torch.bfloat16)
        assert not kernel.uses_kernel(
            x, torch.bfloat16,
            fargan.Uniform(torch.Generator().manual_seed(0)))
    monkeypatch.setattr(kernel, 'KERNEL_DEVICES', ('cuda',))
    with torch.no_grad():
        assert not kernel.uses_kernel(x, torch.bfloat16)


def test_kernel_reads_only_its_slots_inputs():
    """K4 reads a subframe's inputs from its slots: a call given other
    tensors is refused before anything is built or launched"""
    from promonet_tpu_torch.ops import fargan as kernel
    backbone = port.models.init.seeded(fargan.FARGAN(13, 6), 14).eval()
    slots = kernel.Slots(
        torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16),
        torch.zeros((1, 1, 68), dtype=torch.long),
        torch.zeros((1, 512)), backbone.initial_states(
            1, torch.bfloat16, 'cpu')[1], torch.bfloat16)
    features, lookback, previous, states, *_ = slots.step(0)
    launches = kernel.subframe.launches
    with torch.no_grad(), pytest.raises(ValueError, match='slots'):
        backbone.subframe(
            features.clone(), lookback, previous, states, torch.bfloat16,
            None, slots, 0)
    with torch.no_grad(), pytest.raises(ValueError, match='slots'):
        backbone.subframe(
            features, lookback, previous, tuple(states), torch.bfloat16,
            None, slots, 1)
    assert kernel.subframe.launches == launches
    assert slots.plan is None
