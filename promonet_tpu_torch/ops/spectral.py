"""Spectral weighting and dB conversion (librosa semantics)

Counterpart of `promonet_tpu/ops/spectral.py`.
"""
import math

import numpy as np
import torch


def fft_frequencies(sample_rate, n_fft):
    """Center frequencies of rFFT bins (librosa.fft_frequencies)"""
    return np.linspace(0, sample_rate / 2, 1 + n_fft // 2, endpoint=True)


def power_to_db(power, ref=1.0, amin=1e-10, top_db=80.0):
    """Power to dB; top_db clips relative to the max over the whole tensor"""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def amplitude_to_db(amplitude, ref=1.0, amin=1e-5, top_db=80.0):
    """Amplitude to dB (librosa.amplitude_to_db)"""
    return power_to_db(
        torch.square(amplitude), ref=ref ** 2, amin=amin ** 2, top_db=top_db)


def a_weighting(frequencies, min_db=-80.0):
    """A-weighting curve in dB (librosa.A_weighting), float64 numpy"""
    f_sq = np.asarray(frequencies, dtype=np.float64) ** 2
    const = np.array([20.6, 107.7, 737.9, 12194.217]) ** 2
    with np.errstate(divide='ignore'):
        weights = 2.0 + 20.0 * (
            np.log10(const[3]) +
            2 * np.log10(f_sq) -
            np.log10(f_sq + const[3]) -
            np.log10(f_sq + const[0]) -
            0.5 * np.log10(f_sq + const[1]) -
            0.5 * np.log10(f_sq + const[2]))
    if min_db is not None:
        weights = np.maximum(weights, min_db)
    return weights
