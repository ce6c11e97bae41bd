"""Signal processing of the reference: STFT, loudness, mels, grids, PPG
sparsity

Frozen copies at commit ce32675 of `promonet_tpu_torch/ops/stft.py`
(`hann_window`, `reflect_pad`, `stft`), `ops/spectral.py`,
`ops/mel.py`, `preprocess/loudness.py` (`from_audio`, `band_average`),
`preprocess/spectrogram.py` (`from_audio`, `linear_to_mel`),
`ops/grid.py` (`sample`, `constant`) and `ops/sparse.py` (`quantile`,
`sparsify`), with the configuration passed as arguments.
"""
import functools
import math

import numpy as np
import torch


# ops/stft.py


def hann_window(size, device=None):
    """Periodic Hann window, computed in float64"""
    n = torch.arange(size, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * n / size)).float()


def reflect_pad(audio, padding):
    """Reflect-pad the last axis of (..., T) on both sides (np.pad's
    'reflect', folding again where the padding exceeds the length)"""
    length = audio.shape[-1]
    index = torch.arange(-padding, length + padding, device=audio.device)
    if length == 1:
        index = torch.zeros_like(index)
    else:
        period = 2 * (length - 1)
        index = torch.remainder(index, period)
        index = torch.where(index < length, index, period - index)
    return audio[..., index]


def stft_magnitude(audio, n_fft, hop_length, epsilon=0.):
    """|STFT| of (..., T) as (..., n_freq, frames); frames start at
    multiples of hop_length, Hann-windowed; sqrt(|S|^2 + epsilon) where
    epsilon is given"""
    frames = audio.unfold(-1, n_fft, hop_length) * hann_window(
        n_fft, audio.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    if epsilon:
        spec = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + epsilon)
    else:
        spec = torch.abs(spec)
    return spec.transpose(-1, -2)


# ops/spectral.py


def fft_frequencies(sample_rate, n_fft):
    return np.linspace(0, sample_rate / 2, 1 + n_fft // 2, endpoint=True)


def amplitude_to_db(amplitude, amin=1e-5, top_db=80.):
    """librosa.amplitude_to_db at ref 1: 10 log10 of the clamped power,
    clipped top_db below the maximum over the whole tensor"""
    log_spec = 10. * torch.log10(torch.clamp(
        torch.square(amplitude), min=amin ** 2))
    return torch.maximum(log_spec, log_spec.max() - top_db)


def a_weighting(frequencies, min_db=-80.):
    """A-weighting curve in dB (librosa.A_weighting), float64"""
    f_sq = np.asarray(frequencies, dtype=np.float64) ** 2
    const = np.array([20.6, 107.7, 737.9, 12194.217]) ** 2
    with np.errstate(divide='ignore'):
        weights = 2.0 + 20.0 * (
            np.log10(const[3]) + 2 * np.log10(f_sq) -
            np.log10(f_sq + const[3]) - np.log10(f_sq + const[0]) -
            0.5 * np.log10(f_sq + const[1]) -
            0.5 * np.log10(f_sq + const[2]))
    return np.maximum(weights, min_db)


# ops/mel.py


def _hz_to_mel(frequencies):
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        frequencies >= min_log_hz,
        min_log_hz / f_sp +
        np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        frequencies / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sample_rate, n_fft, n_mels):
    """Slaney-normalized triangular filterbank (n_mels, n_freq), float32,
    0 Hz to Nyquist (librosa.filters.mel's defaults)"""
    fftfreqs = fft_frequencies(sample_rate, n_fft)
    mel_f = _mel_to_hz(np.linspace(
        _hz_to_mel(0.), _hz_to_mel(sample_rate / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights = weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mels(spectrogram, config, precision):
    """Magnitudes (..., n_freq, T) → log-mels (..., NUM_MELS, T)"""
    basis = torch.from_numpy(mel_filterbank(
        config.SAMPLE_RATE, config.NUM_FFT, config.NUM_MELS)).to(
            spectrogram.device)
    mels = torch.log(precision.result(torch.matmul(
        precision.operand(basis), precision.operand(spectrogram))))
    threshold = config.DYNAMIC_RANGE_COMPRESSION_THRESHOLD
    if threshold is not None:
        mels = torch.clamp(mels, min=math.log(threshold))
    return mels


# preprocess/loudness.py, preprocess/spectrogram.py


def loudness(audio, config):
    """A-weighted loudness (n_freq, frames) of audio (1, T)"""
    audio = reflect_pad(audio, (config.WINDOW_SIZE - config.HOPSIZE) // 2)
    magnitude = stft_magnitude(audio[0], config.WINDOW_SIZE, config.HOPSIZE)
    weights = a_weighting(fft_frequencies(
        config.SAMPLE_RATE, config.WINDOW_SIZE))[:, None] - float(
            config.REF_DB)
    weighted = amplitude_to_db(magnitude) + torch.from_numpy(weights).to(
        audio.device, torch.float32)
    return torch.clamp(weighted, min=config.MIN_DB)


def band_average(loudness, bands):
    """Average (..., F, T) over `bands` bands, the last one uneven"""
    step = loudness.shape[-2] / bands
    return torch.stack([
        loudness[..., int(band * step):int((band + 1) * step), :].mean(dim=-2)
        for band in range(bands)], dim=-2)


def spectrogram(audio, config):
    """Magnitude spectrogram (n_freq, frames) of audio (1, T)"""
    audio = reflect_pad(audio, (config.NUM_FFT - config.HOPSIZE) // 2)
    return stft_magnitude(audio[0], config.NUM_FFT, config.HOPSIZE, 1e-6)


# ops/grid.py


def grid_sample(sequence, grid):
    """Linear interpolation of (..., T) at positions grid (N,), the last
    frame replicated"""
    length = sequence.shape[-1]
    left = torch.clamp(torch.floor(grid).long(), 0, length - 1)
    right = torch.clamp(left + 1, max=length - 1)
    offset = grid - left
    return sequence[..., left] * (1 - offset) + sequence[..., right] * offset


def constant_grid(frames, ratio, device):
    """round(frames / ratio) points spanning [0, frames - 1] uniformly"""
    return torch.linspace(
        0., frames - 1, int(round(frames / ratio)), dtype=torch.float32,
        device=device)


# ops/sparse.py


def quantile(x, q, dim):
    """Linear-interpolation quantile, low * (1 - q') + high * q' in float64"""
    ordered = torch.sort(x, dim=dim).values
    position = torch.tensor(q, dtype=torch.float32) * (x.shape[dim] - 1)
    low = torch.floor(position)
    high_weight = position - low
    low_index = int(low)
    high_index = min(int(torch.ceil(position)), x.shape[dim] - 1)
    low_value = ordered.narrow(dim, low_index, 1).double()
    high_value = ordered.narrow(dim, high_index, 1)
    return (low_value * (1 - high_weight).double() +
            (high_value * high_weight.to(x.dtype)).double()).to(x.dtype)


def sparsify_percentile(ppg, threshold):
    """Zero the probabilities of a frame below its `threshold` quantile
    over (..., C, T) and renormalize"""
    mask = ppg >= quantile(ppg, threshold, dim=-2)
    sparse = torch.where(mask, ppg, torch.zeros_like(ppg))
    return sparse / torch.clamp(sparse.sum(dim=-2, keepdim=True), min=1e-8)
