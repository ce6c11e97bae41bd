"""A-weighted loudness (counterpart of `preprocess/loudness.py`)"""
import torch

from ..ops import spectral, stft as stft_ops


def perceptual_weights(config):
    """A-weighted frequency weights minus REF_DB, float64 (n_freq, 1)"""
    frequencies = spectral.fft_frequencies(
        config.SAMPLE_RATE, config.WINDOW_SIZE)
    return spectral.a_weighting(frequencies)[:, None] - float(config.REF_DB)


def from_audio(audio, config, bands=None):
    """A-weighted loudness of audio (1, T): (n_freq or bands, frames)

    The dB conversion clips at 80 dB below the maximum over the whole
    input (librosa's top_db). bands=None keeps all n_freq bins.
    """
    padding = (config.WINDOW_SIZE - config.HOPSIZE) // 2
    audio = stft_ops.reflect_pad(audio, padding)
    window = stft_ops.hann_window(config.WINDOW_SIZE, device=audio.device)
    magnitude = stft_ops.stft(
        audio[0], config.WINDOW_SIZE, config.HOPSIZE, window=window,
        magnitude=True)
    weights = torch.from_numpy(perceptual_weights(config)).to(
        device=audio.device, dtype=magnitude.dtype)
    weighted = spectral.amplitude_to_db(magnitude) + weights
    weighted = torch.clamp(weighted, min=config.MIN_DB)
    return weighted if bands is None else band_average(weighted, bands)


def band_average(loudness, bands):
    """Average (..., F, T) over `bands` frequency bands"""
    if bands == 1:
        return loudness.mean(dim=-2, keepdim=True)
    step = loudness.shape[-2] / bands
    return torch.stack(
        [
            loudness[..., int(band * step):int((band + 1) * step), :].mean(
                dim=-2)
            for band in range(int(bands))],
        dim=-2)
