"""Unit conversions (counterpart of `promonet_tpu/convert.py`)

Loudness and pitch conversions take Python numbers or tensors; the pitch
bin conversions and the time conversions read their defaults from a
`config.Config` (None: the environment's).
"""
import math

import numpy as np
import torch

from . import config as config_module


###############################################################################
# Loudness conversions
###############################################################################


def db_to_ratio(db):
    """Convert decibels to perceptual loudness ratio"""
    return 2 ** (db / 10)


def ratio_to_db(ratio):
    """Convert perceptual loudness ratio to decibels (a tensor for a
    tensor)"""
    if isinstance(ratio, torch.Tensor):
        return 10 * torch.log2(ratio)
    return 10 * math.log2(ratio)


###############################################################################
# Pitch conversions
###############################################################################


def bins_to_hz(bins, num_bins=None, fmin=None, fmax=None,
               pitch_distribution=None, config=None):
    """Pitch bin indices (int tensor) to Hz, float32

    With config.VARIABLE_PITCH_BINS a bin stands for the log-space
    midpoint between its boundary in `pitch_distribution` (None:
    `load.pitch_distribution(config)`) and the next one (FMAX after the
    last); otherwise bins are log-uniform over [fmin, fmax].
    """
    config = config_module.default() if config is None else config
    num_bins = config.PITCH_BINS if num_bins is None else num_bins
    fmin = config.FMIN if fmin is None else fmin
    fmax = config.FMAX if fmax is None else fmax
    bins = torch.as_tensor(bins)
    if config.VARIABLE_PITCH_BINS:
        distribution = _distribution(
            pitch_distribution, config, bins.device)
        distribution = torch.cat([
            distribution,
            torch.tensor([fmax], dtype=torch.float32, device=bins.device)])
        low, high = distribution[bins], distribution[bins + 1]
        return low + 2 ** ((torch.log2(high) - torch.log2(low)) / 2)
    log_fmin, log_fmax = math.log2(fmin), math.log2(fmax)
    normalized = bins.float() / (num_bins - 1)
    hz = 2 ** (normalized * (log_fmax - log_fmin) + log_fmin)
    return torch.clamp(hz, fmin, fmax)


def cents_to_ratio(cents):
    """Convert pitch ratio in cents to linear ratio"""
    return 2 ** (cents / 1200)


def hz_to_bins(hz, num_bins=None, fmin=None, fmax=None,
               pitch_distribution=None, config=None):
    """Pitch in Hz (float tensor) to int32 bin indices

    The pitch is clipped to [fmin, fmax] first. With
    config.VARIABLE_PITCH_BINS the bin is the left insertion point among
    the distribution's boundaries (as `jnp.searchsorted`), clipped to the
    last bin; otherwise the log-uniform bin, truncated.
    """
    config = config_module.default() if config is None else config
    num_bins = config.PITCH_BINS if num_bins is None else num_bins
    fmin = config.FMIN if fmin is None else fmin
    fmax = config.FMAX if fmax is None else fmax
    hz = torch.clamp(torch.as_tensor(hz), fmin, fmax)
    if config.VARIABLE_PITCH_BINS:
        distribution = _distribution(pitch_distribution, config, hz.device)
        bins = torch.searchsorted(distribution, hz.contiguous(), right=False)
        return torch.clamp(bins, 0, num_bins - 1).to(torch.int32)
    log_fmin, log_fmax = math.log2(fmin), math.log2(fmax)
    normalized = (torch.log2(hz) - log_fmin) / (log_fmax - log_fmin)
    return ((num_bins - 1) * normalized).to(torch.int32)


def ratio_to_cents(ratio):
    """Convert linear pitch ratio to cents (a tensor for a tensor)"""
    if isinstance(ratio, torch.Tensor):
        return 1200 * torch.log2(ratio)
    return 1200 * math.log2(ratio)


def _distribution(pitch_distribution, config, device):
    if pitch_distribution is None:
        from . import load
        pitch_distribution = load.pitch_distribution(config)
    return torch.as_tensor(
        np.asarray(pitch_distribution, np.float32), device=device)


###############################################################################
# Time conversions
###############################################################################


def seconds_to_frames(seconds, config=None):
    """Convert seconds to frames, truncated"""
    config = config_module.default() if config is None else config
    return int(seconds * config.SAMPLE_RATE / config.HOPSIZE)


def frames_to_samples(frames, config=None):
    """Convert number of frames to samples"""
    config = config_module.default() if config is None else config
    return frames * config.HOPSIZE


def frames_to_seconds(frames, config=None):
    """Convert number of frames to seconds"""
    config = config_module.default() if config is None else config
    return frames * samples_to_seconds(config.HOPSIZE, config=config)


def samples_to_seconds(samples, sample_rate=None, config=None):
    """Convert time in samples to seconds"""
    if sample_rate is None:
        config = config_module.default() if config is None else config
        sample_rate = config.SAMPLE_RATE
    return samples / sample_rate


def samples_to_frames(samples, config=None):
    """Convert time in samples to frames, floored"""
    config = config_module.default() if config is None else config
    return samples // config.HOPSIZE
