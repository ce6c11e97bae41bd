"""Batched and streaming synthesis held against the JAX package's.

The same seeded features and the same weights (carried over by the
bridge) go through `synthesize.from_features_batched`, `Streamer` and
`FARGANStreamer` of both packages, with float32 generators: a narrow
HiFi-GAN (initial width 32) and FARGAN. The JAX package finds each
model under a checkpoint key in its model cache. Tolerances: the
existing one of `test_torch_models.py` (rtol 1e-4, atol 1e-4 of the
largest reference value) for HiFi-GAN; for FARGAN the JAX package's own
streaming contract (first four frames within 1e-5, the whole within
2e-3, correlation above 0.9999), as in `test_torch_vocoders.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.synthesize.core as jax_synthesize_core
from promonet_tpu.synthesize import stream as jax_stream

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

HOPSIZE = 256


def _assert_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


def _assert_fargan_contract(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    difference = np.abs(ours - theirs)
    assert difference[..., :4 * HOPSIZE].max() < 1e-5
    assert difference.max() < 2e-3
    correlation = float((ours * theirs).sum()) / float(
        np.linalg.norm(ours) * np.linalg.norm(theirs))
    assert correlation > 0.9999


def _features(frames, seed):
    """Loudness (513, T), pitch (1, T), periodicity (1, T), PPG (40, T)"""
    rng = np.random.default_rng(seed)
    logits = 2 * rng.standard_normal((40, frames))
    t = np.arange(frames)
    return (
        rng.uniform(-80, 10, (513, frames)).astype(np.float32),
        (160 + 40 * np.sin(t / 7.))[None].astype(np.float32),
        rng.uniform(0, 1, (1, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32))


def _shared_generator(model):
    """A float32 generator on both sides with the same weights

    Returns the JAX package's model and weights and the port's generator.
    """
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    params = jax.device_get(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 513, 64)), jnp.full((1, 64), 100.),
        jnp.zeros((1, 64)), jnp.full((1, 40, 64), 1 / 40),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), jnp.ones((1,))))
    rng = np.random.default_rng(1)
    # Perturbed, so that no leaf keeps its initial value
    params = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32) + 0.02 *
        rng.standard_normal(np.shape(leaf)).astype(np.float32), params)
    config = port.config.load().replace(
        MODEL=model, HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, PRECISION='float32')
    generator = port.models.Generator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    return (jax_model, params, jax.jit(jax_model.apply)), generator


@pytest.fixture(scope='module')
def generators():
    """The narrow HiFi-GAN ('narrow') and FARGAN ('fargan'), shared

    The JAX package finds each model under that checkpoint key in its
    model cache.
    """
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', 32)
        cache, ours = {}, {}
        for key, model in (('narrow', 'hifigan'), ('fargan', 'fargan')):
            patch.setattr(promonet_tpu, 'MODEL', model)
            cache[key], ours[key] = _shared_generator(model)
        patch.setattr(promonet_tpu, 'MODEL', 'hifigan')
        patch.setattr(
            jax_synthesize_core._cached_model, 'cache', cache, raising=False)
        yield ours


###############################################################################
# Batched synthesis
###############################################################################


@pytest.mark.parametrize('lengths,batch_size', [
    ((50, 64, 41), 8), ((70, 100, 128, 99, 81), 2)])
def test_batched_rows_match_jax(generators, lengths, batch_size):
    """Untrimmed bucket-length rows, one generator call per group; the
    last group is filled by repeating its rows"""
    generator = generators['narrow']
    sets = [_features(frames, seed) for seed, frames in enumerate(lengths)]
    # NaN pitch becomes 100 Hz
    sets[0][1][0, 3:6] = np.nan
    speakers = list(range(len(sets)))
    balance = [1., 0.9, 1.1, 1., 0.95][:len(sets)]
    theirs = np.asarray(promonet_tpu.synthesize.from_features_batched(
        sets, speakers=speakers, spectral_balance_ratios=balance,
        checkpoint='narrow', batch_size=batch_size))
    calls = []
    hook = generator.register_forward_pre_hook(
        lambda module, args: calls.append(args[0].shape[0]))
    try:
        ours = port.synthesize.from_features_batched(
            sets, generator, speakers=speakers,
            spectral_balance_ratios=balance, batch_size=batch_size,
            device='cpu')
    finally:
        hook.remove()
    bucket = port.data.bucket_frames(
        max(lengths), port.config.load().INFERENCE_FRAME_BUCKETS)
    assert isinstance(ours, torch.Tensor)
    assert tuple(ours.shape) == theirs.shape == (
        len(sets), 1, bucket * HOPSIZE)
    assert calls == [batch_size] * -(-len(sets) // batch_size)
    for row, (a, b) in enumerate(zip(ours.numpy(), theirs)):
        _assert_close(a, b)


def test_batched_pads_by_replicating_the_last_frame(generators):
    """A set padded by replication equals the same set given at its
    bucket's length with the last frame repeated; zero padding changes
    the padded frames' audio"""
    generator = generators['narrow']
    short = _features(50, 3)
    replicated = tuple(
        np.concatenate([x, np.repeat(x[:, -1:], 14, axis=1)], axis=1)
        for x in short)
    zeros = tuple(np.pad(x, ((0, 0), (0, 14))) for x in short)
    ours = port.synthesize.from_features_batched(
        [short, replicated, zeros], generator, device='cpu').numpy()
    np.testing.assert_array_equal(ours[0], ours[1])
    tail = np.abs(ours[0] - ours[2])[..., 50 * HOPSIZE:]
    assert tail.max() > 1e-3 * np.abs(ours[0]).max()


def test_batched_refuses_sets_of_two_buckets(generators):
    generator = generators['narrow']
    sets = [_features(50, 0), _features(100, 1)]
    with pytest.raises(ValueError, match='span buckets'):
        promonet_tpu.synthesize.from_features_batched(
            sets, checkpoint='narrow')
    with pytest.raises(ValueError, match=r'span buckets \[64, 128\]'):
        port.synthesize.from_features_batched(sets, generator, device='cpu')


###############################################################################
# Windowed streaming
###############################################################################


def _stream(streamer, features, step):
    """Feed `step` frames at a time, then flush"""
    frames = features[1].shape[-1]
    chunks = [
        streamer.feed(*(x[:, start:start + step] for x in features))
        for start in range(0, frames, step)]
    chunks.append(streamer.flush())
    return chunks


@pytest.mark.parametrize('frames,step,windows', [
    (70, 10, (8, 16, 8)), (45, 7, (16, 32, 16)), (20, 20, (16, 32, 16))])
def test_streamer_matches_jax(generators, frames, step, windows):
    """Uneven feeds, the first window's replicated history and the
    replicate-padded flush, piece by piece"""
    generator = generators['narrow']
    left, chunk, right = windows
    features = _features(frames, 4)
    kwargs = dict(speaker=2, chunk_frames=chunk, left_frames=left,
                  right_frames=right)
    theirs = _stream(
        jax_stream.Streamer('narrow', **kwargs), features, step)
    streamer = port.synthesize.Streamer(generator, device='cpu', **kwargs)
    ours = _stream(streamer, features, step)
    assert [a.shape for a in ours] == [np.asarray(b).shape for b in theirs]
    assert sum(a.shape[-1] for a in ours) == frames * HOPSIZE
    for a, b in zip(ours, theirs):
        if a.size:
            _assert_close(a, b)
    assert streamer.latency_seconds == pytest.approx(
        right * HOPSIZE / 22050) and streamer.latency_seconds > 0
    # The stream ended: the next one starts with a fresh history
    again = _stream(streamer, features, step)
    for a, b in zip(again, ours):
        np.testing.assert_array_equal(a, b)


###############################################################################
# Exact-state streaming
###############################################################################


def test_fargan_streamer_matches_jax(generators, monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'MODEL', 'fargan')
    monkeypatch.setattr(promonet_tpu, 'NUM_PREVIOUS_SAMPLES', 2 * HOPSIZE)
    generator = generators['fargan']
    features = _features(44, 5)
    theirs = np.concatenate(_stream(
        jax_stream.FARGANStreamer('fargan', speaker=1, chunk_frames=16),
        features, 10), axis=-1)
    streamer = port.synthesize.FARGANStreamer(
        generator, speaker=1, chunk_frames=16, device='cpu')
    pieces = _stream(streamer, features, 10)
    # Whole chunks as soon as they are complete; the flush gives the tail
    assert [a.shape[-1] // HOPSIZE for a in pieces] == [0, 16, 0, 16, 0, 12]
    ours = np.concatenate(pieces, axis=-1)
    assert ours.shape == (1, 44 * HOPSIZE)
    assert streamer.latency_seconds == pytest.approx(16 * HOPSIZE / 22050)
    _assert_fargan_contract(ours, theirs)

    # And against one offline pass of the same generator
    with torch.no_grad():
        offline = generator(
            *(torch.from_numpy(x)[None] if x.shape[0] > 1
              else torch.from_numpy(x) for x in features),
            torch.tensor([1]), torch.ones(1), torch.ones(1))[0].numpy()
    _assert_fargan_contract(ours, offline)


def test_fargan_streamer_refuses_other_backbones(generators):
    with pytest.raises(ValueError, match="MODEL='fargan'"):
        port.synthesize.FARGANStreamer(generators['narrow'], device='cpu')


def test_serving_entry_points_refuse_a_missing_gpu(generators):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the refusal is for hosts without one')
    with pytest.raises(RuntimeError, match='CUDA'):
        port.synthesize.from_features_batched(
            [_features(50, 0)], generators['narrow'])
    with pytest.raises(RuntimeError, match='CUDA'):
        port.synthesize.Streamer(generators['narrow'])
    with pytest.raises(RuntimeError, match='CUDA'):
        port.synthesize.FARGANStreamer(generators['fargan'])
