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
    """Overlapping frames (..., N, frame_length), no centering or padding;
    none (N = 0) where the audio is shorter than a frame"""
    if audio.shape[-1] < frame_length:
        return audio.new_zeros((*audio.shape[:-1], 0, frame_length))
    return audio.unfold(-1, frame_length, hop_length)


def reflect_pad(audio, padding):
    """Reflect-pad the last axis of (..., T) on both sides, as `np.pad`
    and `jnp.pad` with mode='reflect' do

    Sample i of the padded axis reads index i - padding folded into
    [0, T - 1] with period 2 (T - 1), so a padding of T or more reflects
    again and again; a single sample repeats.
    """
    length = audio.shape[-1]
    index = torch.arange(-padding, length + padding, device=audio.device)
    if length == 1:
        index = torch.zeros_like(index)
    else:
        period = 2 * (length - 1)
        index = torch.remainder(index, period)
        index = torch.where(index < length, index, period - index)
    return audio[..., index]


def stft(
    audio,
    n_fft,
    hop_length,
    window=None,
    center=False,
    magnitude=False,
    magnitude_epsilon=0.
):
    """STFT of (..., T), as (..., n_freq, n_frames)

    Frames start at multiples of hop_length; center=True reflect-pads
    n_fft // 2 samples on both sides first, as torch.stft's default does.
    """
    if center:
        audio = reflect_pad(audio, n_fft // 2)
    frames = frame(audio, n_fft, hop_length)
    if frames.shape[-2] == 0:
        # No frame fits; the FFT of none is refused on the CPU
        return torch.zeros(
            (*frames.shape[:-2], n_fft // 2 + 1, 0), device=audio.device,
            dtype=audio.dtype if magnitude else torch.complex64)
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
