"""Speaker embeddings for zero-shot conditioning

Counterpart of `promonet_tpu/preprocess/speaker.py`. `from_audio`
resolves as the JAX package does, without its first step:

1. WavLM x-vectors are not ported: the model is not in the repository,
   and the JAX package takes that path only where it is cached locally;
2. the x-vector-style `SpeakerEncoder`, when its weights are given or
   found in config.CHECKPOINTS_DIR (`load.speaker_encoder`);
3. otherwise `spectral_embedding`, per-band log-mel statistics that need
   no weights.

Every embedding is a unit-norm float32 (WAVLM_EMBEDDING_CHANNELS,)
tensor on the device the audio was analysed on.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..models.modules import Conv1d
from ..utils import audio as audio_module
from . import spectrogram as spectrogram_module

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
        x = mels.float()
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        mask = (
            torch.arange(x.shape[-2], device=x.device)[None, :, None] <
            frames[:, None, None])
        denominator = torch.clamp(frames[:, None].float(), min=1.)
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
        encoder: a `SpeakerEncoder` with its weights, on `device`; None
            reads config.CHECKPOINTS_DIR, and uses `spectral_embedding`
            where no checkpoint is there
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
    if sample_rate is not None and sample_rate != config.SAMPLE_RATE:
        audio = audio_module.resample(
            _to_numpy(audio), sample_rate, config.SAMPLE_RATE)
    return encoder_embedding(audio, encoder, config, device)


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
