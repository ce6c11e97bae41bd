"""Mel filterbank and log-mels (librosa Slaney scale and norm)

Counterpart of `promonet_tpu/ops/mel.py`. The basis is built in float64
numpy exactly as there, then cast to float32.
"""
import functools

import numpy as np
import torch

from .spectral import fft_frequencies


def hz_to_mel(frequencies):
    """Hz to mel (Slaney scale)"""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        frequencies >= min_log_hz,
        min_log_mel +
        np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        frequencies / f_sp)


def mel_to_hz(mels):
    """Mel to Hz (Slaney scale)"""
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        f_sp * mels)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-normalized triangular filterbank (n_mels, n_freq), float32

    Spans `fmin` to `fmax` Hz (None: Nyquist), by default librosa.filters.
    mel's 0 Hz to Nyquist. Cached on all five arguments; read-only.
    """
    if fmax is None:
        fmax = sample_rate / 2
    fftfreqs = fft_frequencies(sample_rate, n_fft)
    mel_f = mel_to_hz(
        np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    weights = weights.astype(np.float32)
    weights.flags.writeable = False
    return weights


def linear_to_mel(
    spectrogram,
    sample_rate,
    n_fft,
    n_mels,
    log_dynamic_range_compression_threshold=None
):
    """Magnitude spectrogram (..., n_freq, T) to log-mels (..., n_mels, T)"""
    basis = _basis(sample_rate, n_fft, n_mels, spectrogram.device)
    mels = torch.log(torch.matmul(basis, spectrogram.float()).to(
        spectrogram.dtype))
    if log_dynamic_range_compression_threshold is not None:
        mels = torch.clamp(mels, min=log_dynamic_range_compression_threshold)
    return mels


@functools.lru_cache(maxsize=16)
def _basis(sample_rate, n_fft, n_mels, device):
    """`mel_filterbank` as a tensor on `device`, copied there once: a step
    that a CUDA graph holds copies nothing from the host. Made outside
    inference mode, so that autograd may save it whatever mode its first
    caller ran in."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            mel_filterbank(sample_rate, n_fft, n_mels).copy()).to(device)
