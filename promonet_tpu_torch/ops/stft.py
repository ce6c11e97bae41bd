"""Short-time Fourier analysis and synthesis (counterpart of
`promonet_tpu/ops/stft.py`)
"""
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


def overlap_add(frames, hop_length):
    """Overlap-add frames (..., frame_length, n_frames) → (..., T)

    T = (n_frames - 1) * hop_length + frame_length.
    """
    *leading, frame_length, num_frames = frames.shape
    length = (num_frames - 1) * hop_length + frame_length
    audio = F.fold(
        frames.reshape(-1, frame_length, num_frames),
        output_size=(1, length), kernel_size=(1, frame_length),
        stride=(1, hop_length))
    return audio.reshape(*leading, length)


def istft(spec, n_fft, hop_length, window):
    """Inverse STFT normalised by the squared-window envelope

    irfft of each frame, window, overlap-add, trim (n_fft - hop) // 2
    samples on both sides and divide by the overlap-added squared window,
    as the JAX package's Vocos head does.

    Arguments
        spec: complex STFT (..., n_freq, n_frames)
        window: (n_fft,) float32 synthesis window

    Returns
        audio (..., n_frames * hop_length)
    """
    num_frames = spec.shape[-1]
    pad = (n_fft - hop_length) // 2
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    audio = overlap_add(frames.transpose(-1, -2), hop_length)
    envelope = overlap_add(
        (window * window)[:, None].expand(n_fft, num_frames), hop_length)
    return audio[..., pad:-pad] / envelope[pad:-pad]
