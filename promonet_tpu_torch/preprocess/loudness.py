"""A-weighted loudness (counterpart of `preprocess/loudness.py`)"""
import numpy as np
import torch

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..convert import db_to_ratio
from ..ops import grid as grid_ops, spectral, stft as stft_ops


def perceptual_weights(config):
    """A-weighted frequency weights minus REF_DB, float64 (n_freq, 1)"""
    frequencies = spectral.fft_frequencies(
        config.SAMPLE_RATE, config.WINDOW_SIZE)
    return spectral.a_weighting(frequencies)[:, None] - float(config.REF_DB)


def from_audio(audio, config=None, bands=1):
    """A-weighted loudness of audio (1, T): (n_freq or bands, frames)

    The dB conversion clips at 80 dB below the maximum over the whole
    input (librosa's top_db). bands=1, the JAX package's default, is the
    mean over all bins; bands=None keeps all n_freq bins.
    """
    config = config_module.default() if config is None else config
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


def from_file(audio_file, bands=None, config=None, device='cuda'):
    """A-weighted loudness of a wav file; bands None takes
    config.LOUDNESS_BANDS"""
    config = config_module.default() if config is None else config
    if bands is None:
        bands = config.LOUDNESS_BANDS
    audio = torch.from_numpy(load.audio(audio_file, config)).to(
        device_module.resolve(device))
    return from_audio(audio, config, bands)


def from_file_to_file(audio_file, output_file, bands=None, config=None,
                      device='cuda'):
    """A-weighted loudness of a wav file, saved to `output_file`"""
    load.save_array(
        output_file, from_file(audio_file, bands, config, device))


def from_files_to_files(audio_files, output_files, bands=None, config=None,
                        device='cuda'):
    """A-weighted loudness of several wav files, in turn"""
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, bands, config, device)


def normalize(loudness, config=None):
    """Loudness in dB mapped from [MIN_DB, REF_DB] to [0, 1]"""
    config = config_module.default() if config is None else config
    return (loudness - config.MIN_DB) / (config.REF_DB - config.MIN_DB)


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


###############################################################################
# Loudness matching
###############################################################################


def scale(audio, target_loudness, config):
    """Scale audio (1, T) to a target A-weighted loudness in dB

    `target_loudness` is (..., F or 1, frames); several bands are averaged
    first. The gain is db_to_ratio of the difference, passed to `shift`,
    which converts it once more, as the JAX package's `scale` does; then
    `limit`.
    """
    target_loudness = torch.as_tensor(target_loudness, device=audio.device)
    if target_loudness.dim() >= 2 and target_loudness.shape[-2] > 1:
        target_loudness = target_loudness.mean(dim=-2, keepdim=True)
    loudness = from_audio(audio, config, bands=1)
    gain = db_to_ratio(target_loudness - loudness)
    return limit(shift(audio, gain))


def shift(audio, value):
    """Shift the loudness of audio (1, T) by value dB: a scalar, or one
    per frame, interpolated to the samples (align_corners=False)

    The gain is computed in the audio's dtype: a float64 `value` leaves
    float32 audio float32, as in the JAX package.
    """
    gain = db_to_ratio(torch.as_tensor(
        value, dtype=audio.dtype, device=audio.device))
    if gain.numel() > 1:
        samples, frames = audio.shape[-1], gain.shape[-1]
        positions = (torch.arange(
            samples, dtype=torch.float32, device=audio.device) + 0.5) * (
                frames / samples) - 0.5
        gain = grid_ops.sample(gain, torch.clamp(positions, 0, frames - 1))
    return gain * audio


def limit(audio, delay=40, attack_coef=.9, release_coef=.9995, threshold=.99):
    """Feed-forward limiter of audio (1, T), against clipping

    A sample-by-sample recurrence in float32 (a loop on the host), as the
    JAX package's scan computes it.
    """
    samples = np.pad(
        audio.detach().cpu().numpy().astype(np.float32)[0], (0, delay - 1))
    line = np.zeros(delay, np.float32)
    index = 0
    gain, envelope = np.float32(1.), np.float32(0.)
    attack, release = np.float32(attack_coef), np.float32(release_coef)
    rest, bound = np.float32(1 - attack_coef), np.float32(threshold)
    out = np.empty_like(samples)
    for i, sample in enumerate(samples):
        line[index] = sample
        index = (index + 1) % delay
        envelope = max(abs(sample), envelope * release)
        target = bound / envelope if envelope > bound else np.float32(1.)
        gain = gain * attack + target * rest
        out[i] = line[index] * gain
    return torch.from_numpy(out[None, delay - 1:]).to(audio.device)
