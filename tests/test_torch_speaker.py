"""Zero-shot speakers held against the JAX package's.

The speaker encoder runs with the shipped speaker checkpoint on both
sides, restored by the JAX package's loader and carried over by
`bridge.speaker_state_dict`. Zero-shot synthesis runs a float32
generator (a narrow HiFi-GAN of four Blocks, or FARGAN) with the same
weights, drawn from a numpy seed, on both sides, found by the JAX package
under a checkpoint key in its model cache, and x-vectors drawn from a
numpy seed.

Tolerances: embeddings are unit vectors in float32, held to 1e-6 per
element (seen: 2e-7). The generator and every synthesis entry point to
the existing tolerance of `test_torch_models.py` (rtol 1e-4, atol 1e-4
of the largest reference value); FARGAN to the JAX package's streaming
contract, as in `test_torch_stream.py`; `from_edited_audio` to 1e-3 of
the peak, as in `test_torch_pipeline.py`. The zero-shot Dense in bf16
is held to one bf16 step of the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.synthesize.core as jax_synthesize_core
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg
from promonet_tpu.preprocess import speaker as jax_speaker
from promonet_tpu.synthesize import stream as jax_stream
from promonet_tpu.utils import checkpoint as jax_checkpoint

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.preprocess import speaker
from promonet_tpu_torch.utils import checkpoint

SPEAKER = 'promonet_tpu/assets/checkpoints/speaker'
HOPSIZE = 256
SAMPLE_RATE = 22050
EMBEDDING_ATOL = 1e-6


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


def _harmonic_audio(seconds, seed=0):
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    audio += 0.01 * np.random.default_rng(seed).standard_normal(t.shape)
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def _xvectors(count, seed):
    vectors = np.random.default_rng(seed).standard_normal((count, 512))
    return (vectors / np.linalg.norm(vectors, axis=1, keepdims=True)).astype(
        np.float32)


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


def _stream(streamer, features, step):
    frames = features[1].shape[-1]
    pieces = [
        np.asarray(streamer.feed(*(x[..., start:start + step]
                                   for x in features)))
        for start in range(0, frames, step)]
    return pieces + [np.asarray(streamer.flush())]


###############################################################################
# The speaker encoder and the embeddings
###############################################################################


@pytest.fixture(scope='module')
def encoder():
    """The shipped speaker checkpoint: its JAX params and the port's model"""
    params = jax.device_get(jax_checkpoint.load(SPEAKER)['params'])
    model = speaker.SpeakerEncoder()
    model.load_state_dict(bridge.speaker_state_dict(params), strict=True)
    return params, model.eval()


def test_speaker_encoder_matches_jax(encoder):
    params, model = encoder
    # Every leaf used once: four convs and LayerNorms and the Dense
    assert len(jax.tree_util.tree_leaves(params)) == len(model.state_dict())
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra['params']['Extra_0'] = {'kernel': np.zeros(2)}
    with pytest.raises(ValueError, match='Extra_0'):
        bridge.speaker_state_dict(extra)
    mels = np.random.default_rng(0).standard_normal(
        (2, 150, 80)).astype(np.float32) - 4
    frames = np.array([150, 97], np.int32)
    theirs = np.asarray(jax_speaker.SpeakerEncoder().module.apply(
        params, jnp.asarray(mels), jnp.asarray(frames)))
    with torch.no_grad():
        ours = model(torch.from_numpy(mels), torch.from_numpy(frames))
    assert tuple(ours.shape) == theirs.shape == (2, 512)
    _assert_close(ours.numpy(), theirs)


@pytest.mark.parametrize('frames', [128, 200, 301])
def test_encoder_embedding_matches_jax(encoder, frames):
    """At 128 frames and at two lengths that are not a multiple of 128

    The mels are padded to a multiple of 128 frames on both sides. The
    padding is part of the result: zero mel frames are not silence, the
    first layer's output there is not zero, and the dilated layers carry
    it into the last valid frames. Without it, the embedding at the other
    lengths moves by more than 1e-4.
    """
    _, model = encoder
    audio = _harmonic_audio(frames * HOPSIZE / SAMPLE_RATE, seed=frames)
    theirs = jax_speaker.encoder_embedding(audio)
    ours = speaker.encoder_embedding(audio, model, device='cpu')
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (512,)
    assert abs(float(torch.linalg.vector_norm(ours)) - 1) < 1e-6
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=EMBEDDING_ATOL)
    mels = speaker._mels(audio, port.config.load(), 'cpu').T[None]
    with torch.no_grad():
        unpadded = speaker._unit(model(
            mels, torch.tensor([mels.shape[-2]]))[0]).numpy()
    moved = np.abs(unpadded - theirs).max()
    assert moved > 1e-4 if frames % 128 else moved < EMBEDDING_ATOL


@pytest.mark.parametrize('seconds', [0.3, 1.])
def test_spectral_embedding_matches_jax(seconds):
    audio = _harmonic_audio(seconds, seed=3)
    theirs = jax_speaker.spectral_embedding(audio)
    ours = speaker.spectral_embedding(audio, device='cpu')
    assert tuple(ours.shape) == (512,) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=EMBEDDING_ATOL)


def test_from_audio_resolves_as_jax_does(
    encoder, tmp_path, capsys, monkeypatch
):
    """No checkpoint: the spectral embedding, with a notice. The converted
    checkpoint in the port's directory: the encoder, also for audio at
    another rate, as the JAX package with its shipped checkpoint

    The JAX package tries WavLM first, where it is cached locally; it is
    not here, and the port has no WavLM path, so that step is skipped on
    the JAX side as well (it would import transformers for nothing).
    """
    monkeypatch.setattr(jax_speaker, '_wavlm', lambda: None)
    params, _ = encoder
    config = port.config.load().replace(CHECKPOINTS_DIR=tmp_path)
    audio = _harmonic_audio(0.7, seed=4)
    without = speaker.from_audio(audio, config=config, device='cpu')
    assert 'spectral' in capsys.readouterr().err
    np.testing.assert_array_equal(
        without.numpy(),
        speaker.spectral_embedding(audio, config, 'cpu').numpy())

    checkpoint.save(tmp_path / 'speaker-00004000.pt',
                    bridge.speaker_state_dict(params), step=4000)
    for sample_rate in (None, 16000):
        given = audio if sample_rate is None else \
            port.utils.audio.resample(audio, SAMPLE_RATE, sample_rate)
        theirs = jax_speaker.from_audio(given, sample_rate=sample_rate)
        ours = speaker.from_audio(
            given, sample_rate=sample_rate, config=config, device='cpu')
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=EMBEDDING_ATOL)
    assert capsys.readouterr().err == ''


def test_speaker_feature_matches_jax(encoder, tmp_path, monkeypatch):
    """preprocess.from_audio and from_file_to_file with 'speaker' (the
    JAX package's WavLM step skipped, as above)"""
    monkeypatch.setattr(jax_speaker, '_wavlm', lambda: None)
    _, model = encoder
    audio = _harmonic_audio(0.5, seed=5)
    features = ('loudness', 'speaker')
    theirs = promonet_tpu.preprocess.from_audio(audio, features=features)
    ours = port.preprocess.from_audio(
        audio, None, None, features=features, device='cpu',
        speaker_model=model)
    assert len(ours) == 2 and tuple(ours[1].shape) == (512,)
    np.testing.assert_allclose(
        ours[1].numpy(), np.asarray(theirs[1]), rtol=0, atol=EMBEDDING_ATOL)

    file = tmp_path / 'speech.wav'
    port.utils.audio.save(file, audio, SAMPLE_RATE)
    (tmp_path / 'ours').mkdir()
    (tmp_path / 'theirs').mkdir()
    port.preprocess.from_file_to_file(
        file, None, None, tmp_path / 'ours' / 'speech', features=('speaker',),
        device='cpu', speaker_model=model)
    promonet_tpu.preprocess.from_file_to_file(
        file, tmp_path / 'theirs' / 'speech', features=('speaker',))
    names = sorted(path.name for path in (tmp_path / 'ours').iterdir())
    assert names == sorted(
        path.name for path in (tmp_path / 'theirs').iterdir()) == [
        'speech-speaker.npy']
    np.testing.assert_allclose(
        np.load(tmp_path / 'ours' / 'speech-speaker.npy'),
        np.load(tmp_path / 'theirs' / 'speech-speaker.npy'), rtol=0,
        atol=EMBEDDING_ATOL)


###############################################################################
# Zero-shot synthesis
###############################################################################


# A narrow HiFi-GAN with one residual kernel size: four Blocks, not
# twelve, so that each JAX program compiles in a second or two
NARROW = dict(HIFIGAN_UPSAMPLE_INITIAL_SIZE=16,
              HIFIGAN_RESBLOCK_KERNEL_SIZES=[3],
              HIFIGAN_RESBLOCK_DILATION_SIZES=[[1, 3, 5]])


def _seeded_params(shapes, seed):
    """Parameters of the given shapes from a numpy seed, with no JAX init

    As `port.models.init.seeded` draws them: kernels uniform in
    ±1/sqrt(fan_in), weight norm's g at ||v|| (so the effective kernel is
    v), embeddings standard normal, LayerNorms at (1, 0); then every leaf
    perturbed by 0.02 * N(0, 1), so that none keeps its initial value.
    """
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        name = jax.tree_util.keystr(path[-1:])
        shape = tuple(shape.shape)
        fan_in = int(np.prod(shape[:-1])) or 1
        bound = 1. / np.sqrt(fan_in)
        if 'embedding' in name:
            value = rng.standard_normal(shape)
        elif 'scale' in name:
            value = np.ones(shape)
        elif 'kernel_g' in name:
            value = np.full(shape, np.sqrt(fan_in * bound ** 2 / 3))
        elif 'kernel' in name or 'bias' in name:
            value = rng.uniform(-bound, bound, shape)
        else:
            value = np.zeros(shape)
        return (value + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _shared_zero_shot(model, seed, config_file, overrides):
    """A float32 zero-shot generator on both sides with the same weights

    Returns the JAX package's cache entry and the port's generator.
    """
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    shapes = jax.eval_shape(
        jax_model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 513, 16)), jnp.full((1, 16), 100.),
        jnp.zeros((1, 16)), jnp.full((1, 40, 16), 1 / 40),
        jnp.zeros((1, 512)), jnp.ones((1,)), jnp.ones((1,)))
    params = _seeded_params(shapes, seed)
    config = port.config.load(config_file).replace(
        PRECISION='float32', **overrides)
    assert config.ZERO_SHOT and config.MODEL == model
    generator = port.models.Generator(config)
    generator.load_state_dict(bridge.generator_state_dict(params))
    return (jax_model, params, jax.jit(jax_model.apply)), generator


@pytest.fixture(scope='module')
def zero_shot():
    """Zero-shot narrow HiFi-GAN ('zeroshot') and FARGAN
    ('fargan-zeroshot') on both sides; the port's as a dict by key"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'ZERO_SHOT', True)
        for name, value in NARROW.items():
            patch.setattr(promonet_tpu, name, value)
        cache, ours = {}, {}
        for seed, (key, model, config_file, overrides) in enumerate((
            ('zeroshot', 'hifigan', 'configs/promonet-zeroshot.py', NARROW),
            ('fargan-zeroshot', 'fargan', 'configs/fargan-zeroshot.py', {}),
        )):
            patch.setattr(promonet_tpu, 'MODEL', model)
            cache[key], ours[key] = _shared_zero_shot(
                model, seed, config_file, overrides)
        patch.setattr(promonet_tpu, 'MODEL', 'hifigan')
        patch.setattr(
            jax_synthesize_core._cached_model, 'cache', cache, raising=False)
        yield ours


@pytest.mark.parametrize('utterances', [1, 3])
def test_zero_shot_generator_matches_jax(zero_shot, utterances):
    jax_model, params, apply = jax_synthesize_core._cached_model.cache[
        'zeroshot']
    # The bucket of `test_from_features_takes_an_xvector`: one program
    frames = 64
    features = [_features(frames, seed) for seed in range(utterances)]
    inputs = [
        np.stack([f[0] for f in features]),
        np.concatenate([f[1] for f in features]),
        np.concatenate([f[2] for f in features]),
        np.stack([f[3] for f in features]),
        _xvectors(utterances, 1),
        np.linspace(0.8, 1.2, utterances).astype(np.float32),
        np.linspace(1.1, 0.9, utterances).astype(np.float32)]
    theirs = np.asarray(apply(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        ours = zero_shot['zeroshot'](*map(torch.from_numpy, inputs))
    assert tuple(ours.shape) == theirs.shape == (
        utterances, 1, frames * HOPSIZE)
    _assert_close(ours.numpy(), theirs)


def test_zero_shot_dense_rounds_in_bf16_as_flax(zero_shot):
    """In bf16 the x-vector Dense rounds as Flax's `Dense(dtype=bf16)`"""
    _, params, _ = jax_synthesize_core._cached_model.cache['zeroshot']
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'ZERO_SHOT', True)
        for name, value in NARROW.items():
            patch.setattr(promonet_tpu, name, value)
        jax_model = promonet_tpu.models.Generator.create(dtype=jnp.bfloat16)
    inputs = (_xvectors(4, 2), np.full(4, 1.1, np.float32),
              np.full(4, 0.9, np.float32))
    theirs = np.asarray(jax_model.apply(
        params, *map(jnp.asarray, inputs),
        method=jax_model.prepare_global_features).astype(jnp.float32))
    generator = port.models.Generator(
        zero_shot['zeroshot'].config.replace(PRECISION='bfloat16'))
    generator.load_state_dict(zero_shot['zeroshot'].state_dict())
    with torch.no_grad():
        ours = generator.prepare_global_features(
            *map(torch.from_numpy, inputs))
        full = zero_shot['zeroshot'].prepare_global_features(
            *map(torch.from_numpy, inputs))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (4, 1, 258)
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, theirs, rtol=2 ** -8, atol=0)
    assert not np.array_equal(ours, full.numpy())


def test_from_features_takes_an_xvector(zero_shot):
    features = _features(37, 3)
    xvector = _xvectors(1, 3)[0]
    theirs = promonet_tpu.synthesize.from_features(
        *features, speaker=xvector, checkpoint='zeroshot')
    ours = port.synthesize.from_features(
        *features, generator=zero_shot['zeroshot'], speaker=xvector,
        device='cpu')
    assert ours.shape == theirs.shape == (1, 37 * HOPSIZE)
    _assert_close(ours, theirs)
    # A tensor on the device serves as well as numpy
    np.testing.assert_array_equal(ours, port.synthesize.from_features(
        *features, generator=zero_shot['zeroshot'],
        speaker=torch.from_numpy(xvector), device='cpu'))


def test_speakers_of_the_wrong_form_are_refused(zero_shot):
    features = _features(20, 4)
    narrow = port.models.Generator(port.config.load().replace(
        PRECISION='float32', **NARROW))
    for generator, wrong, match in (
        (zero_shot['zeroshot'], 3, r'\(512,\) x-vector'),
        (zero_shot['zeroshot'], _xvectors(1, 0)[0][:256], r'\(512,\)'),
        (narrow, _xvectors(1, 0)[0], 'integer speaker ids'),
        (narrow, 2.5, 'integer speaker ids'),
    ):
        with pytest.raises(ValueError, match=match):
            port.synthesize.from_features(
                *features, generator=generator, speaker=wrong, device='cpu')
        with pytest.raises(ValueError, match=match):
            port.synthesize.from_features_batched(
                [features], generator, speakers=[wrong], device='cpu')
        with pytest.raises(ValueError, match=match):
            port.synthesize.Streamer(generator, speaker=wrong, device='cpu')


def test_batched_xvectors_match_jax(zero_shot):
    """Float32 (B, 512) speakers, one call per group of two"""
    sets = [_features(frames, seed) for seed, frames in enumerate((50, 64,
                                                                   41))]
    speakers = list(_xvectors(3, 5))
    theirs = np.asarray(promonet_tpu.synthesize.from_features_batched(
        sets, speakers=speakers, checkpoint='zeroshot', batch_size=2))
    ours = port.synthesize.from_features_batched(
        sets, zero_shot['zeroshot'], speakers=speakers, batch_size=2,
        device='cpu')
    assert tuple(ours.shape) == theirs.shape == (3, 1, 64 * HOPSIZE)
    for a, b in zip(ours.numpy(), theirs):
        _assert_close(a, b)


def test_streamer_takes_an_xvector(zero_shot):
    features = _features(30, 6)
    kwargs = dict(speaker=_xvectors(1, 6)[0], chunk_frames=8, left_frames=4,
                  right_frames=4)
    theirs = _stream(jax_stream.Streamer('zeroshot', **kwargs), features, 9)
    ours = _stream(port.synthesize.Streamer(
        zero_shot['zeroshot'], device='cpu', **kwargs), features, 9)
    assert [a.shape for a in ours] == [b.shape for b in theirs]
    assert sum(a.shape[-1] for a in ours) == 30 * HOPSIZE
    for a, b in zip(ours, theirs):
        if a.size:
            _assert_close(a, b)


def test_fargan_streamer_takes_an_xvector(zero_shot, monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'MODEL', 'fargan')
    monkeypatch.setattr(promonet_tpu, 'NUM_PREVIOUS_SAMPLES', 2 * HOPSIZE)
    features = _features(20, 7)
    xvector = _xvectors(1, 7)[0]
    theirs = np.concatenate(_stream(jax_stream.FARGANStreamer(
        'fargan-zeroshot', speaker=xvector, chunk_frames=16), features, 10),
        axis=-1)
    ours = np.concatenate(_stream(port.synthesize.FARGANStreamer(
        zero_shot['fargan-zeroshot'], speaker=xvector, chunk_frames=16,
        device='cpu'), features, 10), axis=-1)
    assert ours.shape == (1, 20 * HOPSIZE)
    _assert_fargan_contract(ours, theirs)


def test_from_edited_audio_takes_an_xvector(zero_shot):
    """The one-call edit with the shipped pitch CNN and PPG encoder"""
    pitch_model = port.preprocess.PitchCNN()
    pitch_model.load_state_dict(bridge.pitch_state_dict(
        jax.device_get(jax_pitch.PitchCNN.instance().params)))
    ppg_model = port.preprocess.PPGEncoder()
    ppg_model.load_state_dict(bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])))
    audio = _harmonic_audio(0.5)
    kwargs = dict(pitch_shift_cents=400., time_stretch_ratio=1 / 1.4,
                  loudness_scale_db=3., speaker=_xvectors(1, 8)[0])
    theirs = promonet_tpu.synthesize.from_edited_audio(
        audio, checkpoint='zeroshot', **kwargs)
    ours = port.synthesize.from_edited_audio(
        audio, pitch_model, ppg_model, zero_shot['zeroshot'], device='cpu',
        **kwargs)
    assert ours.shape == theirs.shape == (1, round(43 * 1.4) * HOPSIZE)
    np.testing.assert_allclose(
        ours, theirs, rtol=0, atol=1e-3 * np.abs(theirs).max())


def test_synthesize_to_file_takes_an_xvector(zero_shot, tmp_path):
    features = _features(30, 9)
    names = ('loudness', 'pitch', 'periodicity', 'ppg')
    files = [tmp_path / f'speech-{name}.npy' for name in names]
    for file, value in zip(files, features):
        np.save(file, value)
    xvector = _xvectors(1, 9)[0]
    port.synthesize.from_file_to_file(
        *files, tmp_path / 'ours.wav', zero_shot['zeroshot'], speaker=xvector,
        device='cpu')
    promonet_tpu.synthesize.from_file_to_file(
        *files, tmp_path / 'theirs.wav', speaker=xvector,
        checkpoint='zeroshot')
    ours, theirs = (promonet_tpu.utils.audio.load(tmp_path / name)[0]
                    for name in ('ours.wav', 'theirs.wav'))
    assert ours.shape == theirs.shape == (1, 30 * HOPSIZE)
    # One 16-bit step, or 1e-3 of the peak where float32 sum order moves
    # a sample across a step (as `test_torch_files.py`)
    assert np.abs(ours - theirs).max() <= max(
        1 / 32768 + 1e-7, 1e-3 * np.abs(theirs).max())


@pytest.mark.parametrize('config_file', [
    'configs/promonet-zeroshot.py', 'configs/fargan-zeroshot.py'])
def test_zero_shot_configs_build_seeded_generators(config_file):
    config = port.config.load(config_file)
    assert config.ZERO_SHOT and config.WAVLM_EMBEDDING_CHANNELS == 512
    generator = port.models.init.seeded(port.models.Generator(
        config.replace(**NARROW)), 0)
    assert tuple(generator.speaker_embedding.weight.shape) == (256, 512)
    assert generator.speaker_embedding.bias is not None
    with torch.no_grad():
        audio = generator(
            *(torch.from_numpy(x[None] if x.shape[0] > 1 else x)
              for x in _features(6, 0)),
            torch.from_numpy(_xvectors(1, 0)), torch.ones(1), torch.ones(1))
    assert tuple(audio.shape) == (1, 1, 6 * HOPSIZE)
    assert torch.isfinite(audio).all()
