"""Short-time Fourier analysis (counterpart of `promonet_tpu/ops/stft.py`)"""
import math

import torch
import torch.nn.functional as F


def hann_window(size, dtype=torch.float32, device=None):
    """Periodic Hann window, computed in float64 as the JAX package does"""
    n = torch.arange(size, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * n / size)).to(dtype)


def frame(audio, frame_length, hop_length):
    """Overlapping frames (..., N, frame_length), no centering or padding"""
    return audio.unfold(-1, frame_length, hop_length)


def reflect_pad(audio, padding):
    """Reflect-pad the last axis of (..., T) on both sides"""
    shape = audio.shape
    padded = F.pad(audio.reshape(-1, 1, shape[-1]), (padding, padding),
                   mode='reflect')
    return padded.reshape(*shape[:-1], padded.shape[-1])


def stft(
    audio,
    n_fft,
    hop_length,
    window=None,
    magnitude=False,
    magnitude_epsilon=0.
):
    """STFT of (..., T) with center=False, as (..., n_freq, n_frames)"""
    frames = frame(audio, n_fft, hop_length)
    if window is not None:
        frames = frames * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    if magnitude:
        if magnitude_epsilon:
            spec = torch.sqrt(
                spec.real ** 2 + spec.imag ** 2 + magnitude_epsilon)
        else:
            spec = torch.abs(spec)
    return spec.transpose(-1, -2)
