"""Mel-vocoder baseline: reconstruction from spectrograms alone

Counterpart of `promonet_tpu/baseline/mels.py`. The generator is a
`models.MelGenerator` with its weights, as `load.generator` builds it
under a SPECTROGRAM_ONLY configuration (configs/baselines/mels.py); the
JAX function's `checkpoint` argument is that call's. The spectrogram is
vocoded at its own length, without bucket padding, as in the JAX
package.
"""
import numpy as np
import torch

from .. import device as device_module
from ..preprocess import spectrogram as spectrogram_module
from ..synthesize.core import speaker_tensor


def from_features(
    spectrogram,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda'
):
    """Reconstruct audio from a linear spectrogram

    Arguments
        spectrogram: (NUM_FFT // 2 + 1, T) magnitudes (numpy or tensor)
        generator: `models.MelGenerator` with its weights, on `device`
        speaker: integer speaker id, or under ZERO_SHOT a (512,) x-vector
        spectral_balance_ratio, loudness_ratio: the generator's ratios
        device: where to run; 'cuda' raises on a host without a card

    Returns
        audio: (1, T * HOPSIZE) float32 numpy array
    """
    device = device_module.resolve(device)
    spectrogram = torch.as_tensor(
        np.asarray(spectrogram, np.float32)) \
        if not isinstance(spectrogram, torch.Tensor) else spectrogram
    with torch.no_grad():
        audio = generator(
            spectrogram.to(device, torch.float32)[None],
            speaker_tensor([speaker], generator.config, device),
            torch.tensor([spectral_balance_ratio], device=device),
            torch.tensor([loudness_ratio], device=device))
    return audio[0].float().cpu().numpy()


def from_audio(audio, generator, device='cuda', **kwargs):
    """Round trip: the linear spectrogram of audio (1, T), then vocoding

    Keyword arguments are those of `from_features`.
    """
    device = device_module.resolve(device)
    audio = torch.as_tensor(np.asarray(audio, np.float32)) \
        if not isinstance(audio, torch.Tensor) else audio
    spectrogram = spectrogram_module.from_audio(
        audio.to(device, torch.float32), generator.config)
    return from_features(spectrogram, generator, device=device, **kwargs)
