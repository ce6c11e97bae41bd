"""WavLM-Base+ x-vectors (`models.wavlm`) against the plain reference
(`portbench/reference/wavlm.py`) and, where `transformers` is present,
against `transformers.WavLMForXVector` with the same weights; the
normal path through `preprocess.speaker`, `preprocess.from_audio` and
`load.speaker_encoder`; the spans of the speaker stage.

Every comparison runs on the CPU in float32 with seeded random weights
at a small size (hidden 64, 2 layers, 4 heads, three convolutions), on
0.5-2 s clips. This file imports neither JAX nor the JAX package.
"""
import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import promonet_tpu_torch as port
from portbench.drivers import zeroshot
from portbench.reference import wavlm as reference
from promonet_tpu_torch.models import wavlm
from promonet_tpu_torch.utils import timer

SIZES = dict(conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3),
             conv_stride=(5, 2, 2), hidden_size=64, num_layers=2,
             num_heads=4, intermediate_size=128, pos_kernel=16,
             pos_groups=4, tdnn_dim=(32, 32, 32, 32, 64), xvector_dim=512)

# transformers' names of the same sizes
HF_SIZES = dict(
    conv_dim=SIZES['conv_dim'], conv_kernel=SIZES['conv_kernel'],
    conv_stride=SIZES['conv_stride'], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=128, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, tdnn_dim=SIZES['tdnn_dim'],
    xvector_output_dim=512, use_weighted_layer_sum=True)


@pytest.fixture(autouse=True)
def _clean_records():
    timer.reset()
    yield
    timer.reset()


def seeded_state(seed=3):
    """The harness's WavLM weights at the small size, with the norms'
    scales and biases, the layer weights and the gates' constants moved
    off their constant start so that every parameter is exercised"""
    model = wavlm.WavLMXVector(**SIZES, dtype=torch.float32)
    state = zeroshot.wavlm_state(model, seed, torch.device('cpu'))
    generator = torch.Generator().manual_seed(seed)
    for name, value in state.items():
        if name.endswith(('layer_norm.weight', 'layer_norm.bias',
                          'layer_weights', 'gru_rel_pos_const')) or (
                'bias' in name and not value.any()):
            state[name] = value + 0.1 * torch.randn(
                value.shape, generator=generator)
    return state


def port_model(state):
    model = wavlm.WavLMXVector(**SIZES, dtype=torch.float32)
    model.load_state_dict(state)
    return model.eval()


def reference_model(state):
    model = reference.WavLMXVector(**SIZES)
    model.load_state_dict(state)
    return model.eval()


def clip(seconds, seed):
    """Speech-like audio at 16 kHz: a harmonic tone with noise"""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    pitch = 120 + 40 * np.sin(2 * np.pi * 1.3 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / 16000
    audio = sum(np.sin(k * phase) / k for k in range(1, 6))
    audio = audio + 0.1 * rng.standard_normal(len(t))
    return torch.from_numpy((0.3 * audio / np.abs(audio).max()).astype(
        np.float32))


def relative(value, target):
    return float((value - target).norm() / target.norm())


@pytest.mark.parametrize('seconds', [0.5, 1.1, 2.0])
def test_port_matches_the_reference_at_every_stage(seconds):
    """Features, each of the three hidden states, the pooled statistics
    and the x-vector. Both sides compute in float32 with the same
    operations in other orders (grouped convolution against a written
    out one, SDPA against an explicit softmax); the layers' LayerNorms
    keep the gaps at float32's rounding, measured at about 1e-6
    relative: the limit of 1e-5 leaves ten times that"""
    state = seeded_state()
    audio = clip(seconds, 1)
    with torch.no_grad():
        expected = reference_model(state)(audio)
        model = port_model(state)
        features = model.features(audio[None])
        states = model.encode(features)
        statistics = model.statistics(states)
        xvector = model.xvector(states)
    assert features.shape[1] == wavlm.conv_lengths(
        audio.shape[-1], SIZES['conv_kernel'], SIZES['conv_stride'])
    assert relative(features[0], expected['features']) < 1e-5
    assert len(states) == len(expected['states']) == SIZES['num_layers'] + 1
    for ours, theirs in zip(states, expected['states']):
        assert relative(ours[0], theirs) < 1e-5
    assert relative(statistics[0], expected['statistics']) < 1e-5
    assert relative(xvector[0], expected['xvector']) < 1e-5
    assert xvector.shape == (1, 512) and xvector.dtype == torch.float32


@pytest.mark.parametrize('frames', [1, 2, 79, 80, 81, 800, 801, 1999, 2000])
def test_relative_position_buckets_equal_the_reference(frames):
    """The port's buckets, laid out T x T as its attention uses them,
    equal the reference's as integers"""
    positions = torch.arange(frames)
    expected = reference.buckets(positions, positions, 320, 800)
    table = wavlm.relative_buckets(torch.arange(-(frames - 1), frames))
    ours = table[positions[None, :] - positions[:, None] + frames - 1]
    assert ours.dtype == torch.int64
    assert torch.equal(ours, expected)
    assert int(ours.min()) >= 0 and int(ours.max()) < 320


def test_a_batch_of_two_lengths_equals_each_clip_alone():
    """Padded frames are masked as transformers masks them, and the first
    GroupNorm reads each clip's own frames: float32 rounding only"""
    model = port_model(seeded_state())
    long, short = clip(1.7, 2), clip(0.9, 3)
    batch = torch.zeros(2, long.shape[-1])
    batch[0], batch[1, :short.shape[-1]] = long, short
    lengths = torch.tensor([long.shape[-1], short.shape[-1]])
    with torch.no_grad():
        together = model(batch, lengths)
        alone = torch.cat([model(long[None]), model(short[None])])
    assert torch.allclose(together, alone, rtol=1e-5, atol=1e-6)


def test_from_audio_gives_a_unit_norm_xvector():
    """preprocess.from_audio with 'speaker' and preprocess.speaker.
    from_audio agree: a unit-norm (512,) float32 vector, the x-vector of
    the audio resampled to 16 kHz"""
    config = port.config.load()
    model = port_model(seeded_state())
    rate = config.SAMPLE_RATE
    audio = clip(1.5, 4).numpy()[None]
    audio = port.utils.audio.resample(audio, 16000, rate)
    (embedding,) = port.preprocess.from_audio(
        audio, None, None, features=('speaker',), config=config,
        device='cpu', speaker_model=model)
    assert embedding.shape == (512,) and embedding.dtype == torch.float32
    assert float(embedding.norm()) == pytest.approx(1., abs=1e-5)
    direct = port.preprocess.speaker.from_audio(
        audio, encoder=model, config=config, device='cpu')
    assert torch.allclose(direct, embedding, atol=1e-6)
    resampled = port.utils.audio.resample(audio, rate, 16000)
    with torch.no_grad():
        raw = model(torch.from_numpy(resampled))[0]
    assert torch.allclose(embedding, raw / raw.norm(), atol=1e-6)


def test_the_speaker_stage_records_its_spans_and_counts():
    """preprocess.speaker holds speaker.features, speaker.encoder and
    speaker.xvector, with the 16 kHz samples and the encoder's frames"""
    config = port.config.load()
    model = port_model(seeded_state())
    audio = clip(1.2, 5).numpy()[None]
    with profile(activities=[ProfilerActivity.CPU]):
        port.preprocess.speaker.from_audio(
            audio, encoder=model, sample_rate=16000, config=config,
            device='cpu')
    records = {record.name: record for record in timer.spans()}
    outer = records['preprocess.speaker']
    children = collections.defaultdict(list)
    for record in timer.spans():
        children[record.parent].append(record.name)
    assert children[outer.id] == [
        'speaker.features', 'speaker.encoder', 'speaker.xvector']
    assert outer.counts == {
        'samples': audio.shape[-1],
        'frames': int(model.frames(audio.shape[-1]))}
    for record in records.values():
        assert record.start_ns <= record.end_ns


def test_load_takes_a_wavlm_state_dict_first(tmp_path):
    """A `wavlm*.pt` state dict in CHECKPOINTS_DIR, in transformers'
    names (the weight-norm pair as parametrizations, the classifier
    beside), comes back as the WavLMXVector that computes in PRECISION"""
    state = seeded_state()
    saved = {
        name.replace('weight_g', 'parametrizations.weight.original0')
        .replace('weight_v', 'parametrizations.weight.original1'): value
        for name, value in state.items()}
    saved['classifier.weight'] = torch.zeros(512, 512)
    directory = tmp_path / 'wavlm-small'
    directory.mkdir()
    torch.save(saved, directory / 'pytorch_model.bin')
    (directory / 'config.json').write_text(json.dumps(
        {key: list(value) if isinstance(value, tuple) else value
         for key, value in HF_SIZES.items()}))
    config = port.config.load().replace(CHECKPOINTS_DIR=tmp_path)
    assert port.load.wavlm_checkpoint(config) == directory
    model = port.load.speaker_encoder(config=config, device='cpu')
    assert isinstance(model, wavlm.WavLMXVector)
    assert model.dtype == torch.bfloat16 and not model.training
    for name, value in model.state_dict().items():
        assert torch.equal(value, state[name]), name
    assert port.load.wavlm_checkpoint(
        config.replace(CHECKPOINTS_DIR=tmp_path / 'none')) is None


def test_port_matches_transformers_with_the_same_weights(tmp_path,
                                                        monkeypatch):
    """transformers' WavLMForXVector at the small size with its own random
    initialisation, saved as save_pretrained writes it, read by
    load.speaker_encoder and run by the port: the same embeddings.
    Nothing is downloaded."""
    # transformers' PyTorch side alone, not its TensorFlow or Flax ones
    monkeypatch.setenv('USE_TF', '0')
    monkeypatch.setenv('USE_FLAX', '0')
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(0)
    model = transformers.WavLMForXVector(
        transformers.WavLMConfig(**HF_SIZES)).eval()
    directory = tmp_path / 'wavlm-base-plus-sv'
    model.save_pretrained(directory, safe_serialization=False)
    config = port.config.load().replace(
        CHECKPOINTS_DIR=tmp_path, PRECISION='float32')
    ours = port.load.speaker_encoder(config=config, device='cpu')
    assert isinstance(ours, wavlm.WavLMXVector)
    audio = clip(1.6, 6)[None]
    with torch.no_grad():
        expected = model(audio).embeddings
        found = ours(audio)
    assert relative(found, expected) < 1e-5
