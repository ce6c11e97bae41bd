"""Speaker embeddings for zero-shot conditioning

Counterpart of `promonet_tpu/preprocess/speaker.py`. `from_audio`
resolves as the JAX package does:

1. WavLM-Base+ x-vectors (`models.wavlm.WavLMXVector`, upstream's
   `microsoft/wavlm-base-plus-sv`), when the encoder is given or a
   WavLM state dict is in config.CHECKPOINTS_DIR
   (`load.speaker_encoder`): the audio resampled to 16 kHz on the host,
   then the model on the device (`wavlm_embedding`);
2. the x-vector-style `SpeakerEncoder`, when its weights are given or
   found in config.CHECKPOINTS_DIR or, as the JAX package finds them,
   in its shipped checkpoint;
3. otherwise `spectral_embedding`, per-band log-mel statistics that need
   no weights.

Every embedding is a unit-norm float32 (WAVLM_EMBEDDING_CHANNELS,)
tensor on the device the audio was analysed on. `train` trains the
encoder as a speaker classifier on the formant corpus.
"""
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..models import init, wavlm
from ..models.modules import Conv1d
from ..utils import audio as audio_module
from ..utils import checkpoint, timer
from . import spectrogram as spectrogram_module
from . import training

# (kernel size, dilation) of the encoder's four frame-level layers
LAYERS = ((5, 1), (3, 2), (3, 3), (1, 1))

# The JAX package pads the mels to a multiple of this many frames
FRAME_MULTIPLE = 128


class SpeakerEncoder(nn.Module):
    """x-vector-style encoder: mels → dilated TDNN → stats pool → dense

    The JAX module's Flax defaults, written out: 'SAME' padding (every
    kernel here is odd, so it is (k - 1) * d / 2 on both sides), LayerNorm
    epsilon 1e-6, and masked mean and standard deviation pooling,
    sqrt(var + 1e-6), over the valid frames.
    """

    def __init__(self, num_mels=80, channels=192, embedding_channels=512):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(num_mels if i == 0 else channels, channels, kernel,
                   padding=(kernel - 1) * dilation // 2, dilation=dilation)
            for i, (kernel, dilation) in enumerate(LAYERS))
        self.norms = nn.ModuleList(
            nn.LayerNorm(channels, eps=1e-6) for _ in LAYERS)
        self.output = nn.Linear(2 * channels, embedding_channels)

    def forward(self, mels, frames):
        """mels (B, T, NUM_MELS) and valid frame counts (B,) → (B, E)"""
        x = mels.to(self.output.weight.dtype)
        for conv, norm in zip(self.convs, self.norms):
            if x.shape[-2] == 0:
                # 'SAME' padding of no frames gives no frames
                x = x.new_zeros((*x.shape[:-1], conv.weight.shape[0]))
            else:
                x = F.relu(norm(conv(x, x.dtype)))
        mask = (
            torch.arange(x.shape[-2], device=x.device)[None, :, None] <
            frames[:, None, None])
        denominator = torch.clamp(frames[:, None].to(x.dtype), min=1.)
        mean = torch.sum(x * mask, dim=-2) / denominator
        variance = torch.sum(
            (x - mean[:, None]) ** 2 * mask, dim=-2) / denominator
        return self.output(
            torch.cat([mean, torch.sqrt(variance + 1e-6)], dim=-1))


def from_audio(audio, encoder=None, sample_rate=None, config=None,
               device='cuda'):
    """Unit-norm speaker embedding of audio (1, T)

    Arguments
        audio: (1, T) or (T,) float waveform (numpy or tensor)
        encoder: a `models.wavlm.WavLMXVector` or a `SpeakerEncoder`
            with its weights, on `device`; None takes the encoder
            `load.speaker_encoder` resolves (a WavLM state dict or a
            `speaker-*.pt` in config.CHECKPOINTS_DIR, else the shipped
            checkpoint), and uses `spectral_embedding` where there is
            none
        sample_rate: rate of `audio`; None is config.SAMPLE_RATE
        device: where to run; 'cuda' raises on a host without a card

    Returns
        (WAVLM_EMBEDDING_CHANNELS,) float32 tensor on `device`
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if encoder is None:
        encoder = load.speaker_encoder(config=config, device=device)
    if encoder is None:
        # As in the JAX package, the fallback reads the audio at its rate
        return spectral_embedding(audio, config, device)
    if isinstance(encoder, wavlm.WavLMXVector):
        return wavlm_embedding(
            audio, encoder,
            config.SAMPLE_RATE if sample_rate is None else sample_rate,
            device)
    if sample_rate is not None and sample_rate != config.SAMPLE_RATE:
        audio = audio_module.resample(
            _to_numpy(audio), sample_rate, config.SAMPLE_RATE)
    return encoder_embedding(audio, encoder, config, device)


def wavlm_embedding(audio, encoder, sample_rate, device='cuda'):
    """Unit-norm x-vector of audio (1, T) at `sample_rate` by a
    `models.wavlm.WavLMXVector`

    The audio is resampled to 16 kHz on the host (`utils.audio.
    resample`), as the JAX package resamples it. The span
    `preprocess.speaker` (counts `samples`, the 16 kHz samples, and
    `frames`, the encoder's frames) holds `speaker.features` (the
    resampling, the convolutions and the projection), `speaker.encoder`
    (the positional convolution and the layers) and `speaker.xvector`
    (the weighted sum, the TDNN, the pooling and the dense layer).
    """
    device = device_module.resolve(device)
    with torch.no_grad(), timer.span('preprocess.speaker') as counts:
        with timer.span('speaker.features'):
            audio = audio_module.resample(
                np.asarray(_to_numpy(audio), np.float32).reshape(1, -1),
                sample_rate, wavlm.SAMPLE_RATE)
            samples = audio.shape[-1]
            features = encoder.features(torch.from_numpy(audio).to(device))
        if counts is not None:
            counts.update(samples=samples, frames=features.shape[1])
        with timer.span('speaker.encoder'):
            states = encoder.encode(features)
        with timer.span('speaker.xvector'):
            embedding = encoder.xvector(states)[0]
        return _unit(embedding)


def encoder_embedding(audio, encoder, config=None, device='cuda'):
    """Unit-norm embedding of audio (1, T) by a `SpeakerEncoder`

    The mels are zero-padded to a multiple of FRAME_MULTIPLE frames, as
    in the JAX package. The padding is part of the result: a zero mel
    frame is not silence, the first layer's output there is not zero, and
    the dilated layers carry it into the last seven valid frames. Masked
    pooling leaves out only the padded frames themselves.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    with torch.no_grad():
        mels = _mels(audio, config, device).T[None]
        frames = mels.shape[-2]
        padded = FRAME_MULTIPLE * -(-frames // FRAME_MULTIPLE)
        mels = F.pad(mels, (0, 0, 0, padded - frames))
        embedding = encoder(
            mels, torch.tensor([frames], device=device))[0]
        return _unit(embedding)


def spectral_embedding(audio, config=None, device='cuda'):
    """Unit-norm embedding from per-band log-mel statistics, no weights

    Each mel band's mean, standard deviation and 10th and 90th percentiles
    (linear interpolation, as `np.percentile`), zero-padded to
    WAVLM_EMBEDDING_CHANNELS.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    with torch.no_grad():
        mels = _mels(audio, config, device)
        stats = torch.cat([
            mels.mean(dim=-1),
            mels.std(dim=-1, correction=0),
            torch.quantile(mels, 0.1, dim=-1),
            torch.quantile(mels, 0.9, dim=-1)])
        channels = config.WAVLM_EMBEDDING_CHANNELS
        stats = F.pad(stats, (0, max(0, channels - len(stats))))[:channels]
        return _unit(stats)


def from_file(audio_file, encoder=None, config=None, device='cuda'):
    """Speaker embedding of a wav file; see `from_audio`"""
    config = config_module.default() if config is None else config
    return from_audio(
        load.audio(audio_file, config), encoder, config=config,
        device=device)


def from_file_to_file(audio_file, output_file, encoder=None, config=None,
                      device='cuda'):
    """Speaker embedding of a wav file, saved to `output_file`"""
    load.save_array(
        output_file, from_file(audio_file, encoder, config, device))


def from_files_to_files(audio_files, output_files, encoder=None, config=None,
                        device='cuda'):
    """Speaker embeddings of several wav files, in turn"""
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, encoder, config, device)


###############################################################################
# Training
###############################################################################


def training_examples(dataset, window, config, device):
    """The window bank of `train`

    Each original utterance (stem `<digits>-100`; augmented copies are
    left out) under config.CACHE_DIR / dataset, in sorted order: its
    log-mels (computed on `device`), zero-padded to whole windows and cut
    into windows; a window with fewer than window // 4 valid frames is
    left out. Speakers are the sorted directory names.

    Returns mels (N, window, NUM_MELS) float32, speaker labels (N,) int32,
    valid frames (N,) int32 as numpy, and the speakers.
    """
    cache = config.CACHE_DIR / dataset
    wavs = sorted(cache.glob('*/*.wav'))
    speakers = sorted({wav.parent.name for wav in wavs})
    if len(speakers) < 2:
        raise FileNotFoundError(
            f'Need at least 2 speakers under {cache}; generate the corpus '
            'with promonet_tpu_torch.data.synthetic.create(...)')
    speaker_index = {speaker: i for i, speaker in enumerate(speakers)}
    examples, labels, lengths = [], [], []
    for wav in wavs:
        if not re.fullmatch(r'\d+-100', wav.stem):
            continue
        audio = load.audio(wav, config)
        frames = audio.shape[-1] // config.HOPSIZE
        mels = training.window_mels(audio, frames, window, config, device)
        for start in range(0, len(mels), window):
            valid = min(window, frames - start)
            if valid < window // 4:
                continue
            examples.append(mels[start:start + window])
            labels.append(speaker_index[wav.parent.name])
            lengths.append(valid)
    return (np.stack(examples).astype(np.float32),
            np.asarray(labels, np.int32), np.asarray(lengths, np.int32),
            speakers)


class Classifier(nn.Module):
    """What `train` trains: the encoder and a dense speaker head over its
    embedding, (B, T, NUM_MELS) mels and (B,) valid frames → (B,
    speakers) logits; only the encoder is kept"""

    def __init__(self, num_speakers, num_mels=80, embedding_channels=512):
        super().__init__()
        self.encoder = SpeakerEncoder(
            num_mels, embedding_channels=embedding_channels)
        self.head = nn.Linear(embedding_channels, num_speakers)

    def forward(self, mels, frames):
        return self.head(self.encoder(mels, frames))


def training_loss(model, mels, labels, frames):
    """Cross-entropy of each window's speaker"""
    return F.cross_entropy(model(mels, frames), labels)


def accuracy(model, mels, labels, frames):
    """Share of the windows whose argmax is their speaker"""
    with torch.no_grad():
        predicted = torch.argmax(model(mels, frames), dim=-1)
        return float((predicted == labels).float().mean())


def train(
    dataset='synthetic',
    steps=4000,
    batch_size=32,
    window=256,
    learning_rate=3e-4,
    output=None,
    config=None,
    device='cuda',
    callback=None
):
    """Train the speaker encoder as a speaker classifier

    A `Classifier` seeded from RANDOM_SEED (`models.init`) under one Adam
    (b1 0.9, b2 0.999, eps 1e-8; no schedule, no decay) on
    `training_loss`. The window bank (`training_examples`) is held on
    `device` and each batch gathered there; the held-out split (one
    window in twenty) and the batch indices come from
    `numpy.random.default_rng(RANDOM_SEED)`, as in the JAX package. The
    head is dropped after training.

    Arguments
        output: the checkpoint's directory (None: config.CHECKPOINTS_DIR)
        device: where to train; 'cuda' raises on a host without a card
        callback: called as callback(step, loss) after each step, the
            loss a tensor on `device`

    Returns the held-out window accuracy; writes `speaker-<steps>.pt`
    (the encoder) with 'accuracy', which `load.speaker_encoder` reads.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    examples, labels, lengths, speakers = training_examples(
        dataset, window, config, device)

    rng = np.random.default_rng(config.RANDOM_SEED)
    order = rng.permutation(len(examples))
    num_valid = max(1, len(order) // 20)
    valid_index, train_index = order[:num_valid], order[num_valid:]

    model = init.seeded(
        Classifier(len(speakers), config.NUM_MELS,
                   config.WAVLM_EMBEDDING_CHANNELS),
        config.RANDOM_SEED).to(device).train()
    optimizer = torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(.9, .999), eps=1e-8)
    bank = (
        torch.from_numpy(examples).to(device),
        torch.from_numpy(labels.astype(np.int64)).to(device),
        torch.from_numpy(lengths.astype(np.int64)).to(device))
    valid = [tensor[torch.from_numpy(valid_index).to(device)]
             for tensor in bank]

    batches = training.batches(rng, train_index, batch_size, steps, device)
    for step, batch in enumerate(batches):
        loss = training.update(
            training_loss(model, *(tensor[batch] for tensor in bank)),
            optimizer)
        if callback is not None:
            callback(step, loss)
        if step % 500 == 0:
            print(f'speaker train step {step}: loss {float(loss):.3f}, '
                  f'valid acc {accuracy(model, *valid):.3f}', flush=True)

    model.eval()
    result = accuracy(model, *valid)
    checkpoint.save(
        training.checkpoint_file('speaker', steps, output, config),
        model.encoder.state_dict(), step=steps, accuracy=result)
    return result


def _mels(audio, config, device):
    """Log-mels (NUM_MELS, frames) of audio (1, T) or (T,), on `device`"""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    audio = audio.to(device).float().reshape(1, 1, -1)
    return spectrogram_module.linear_to_mel(
        spectrogram_module.from_audio(audio, config)[0], config)


def _unit(embedding):
    """`embedding` over its norm, unchanged where the norm is 0"""
    norm = torch.linalg.vector_norm(embedding)
    return embedding / torch.where(norm > 0, norm, torch.ones_like(norm))


def _to_numpy(audio):
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)
