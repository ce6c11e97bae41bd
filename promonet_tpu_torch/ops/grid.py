"""1-D grid resampling (counterpart of `promonet_tpu/ops/grid.py`)"""
import numpy as np
import torch

from .. import device as device_module


def sample(sequence, grid, method='linear'):
    """Sample sequence (..., T) at positions grid (N,)

    Linear interpolation between integer neighbours with the final frame
    replicated, or nearest-neighbour rounding.
    """
    length = sequence.shape[-1]
    if method == 'linear':
        left = torch.clamp(torch.floor(grid).long(), 0, length - 1)
        right = torch.clamp(left + 1, max=length - 1)
        offset = grid - left
        return (sequence[..., left] * (1 - offset) +
                sequence[..., right] * offset)
    if method == 'nearest':
        index = torch.clamp(torch.round(grid).long(), 0, length - 1)
        return sequence[..., index]
    raise ValueError(f'Grid sampling method {method} is not defined')


def constant(tensor, ratio):
    """Grid for constant-ratio time-stretching: round(T / ratio) points"""
    return of_length(tensor, int(round(tensor.shape[-1] / ratio)))


def of_length(tensor, length):
    """Grid of `length` points spanning [0, T - 1] uniformly"""
    return torch.linspace(
        0., tensor.shape[-1] - 1, int(length), dtype=torch.float32,
        device=tensor.device)


def masked_interp(values, mask):
    """Linearly interpolate `values` (T,) through positions where mask is False

    Anchors are the nearest True positions on either side; positions
    before the first or after the last anchor take the nearest anchor's
    value, and a mask without anchors gives the last position's value
    everywhere.
    """
    length = values.shape[-1]
    index = torch.arange(length, device=values.device)
    left = torch.cummax(torch.where(mask, index, -1), dim=-1).values
    right = torch.flip(torch.cummin(
        torch.flip(torch.where(mask, index, length), (-1,)), dim=-1).values,
        (-1,))

    # Fall back to the other side when one side has no anchor
    left_anchor = torch.where(left < 0, right, left)
    right_anchor = torch.where(right >= length, left_anchor, right)
    left_anchor = torch.where(left < 0, right_anchor, left_anchor)

    left_value = values[torch.clamp(left_anchor, 0, length - 1)]
    right_value = values[torch.clamp(right_anchor, 0, length - 1)]
    span = right_anchor - left_anchor
    weight = torch.where(
        span > 0,
        (index - left_anchor) / torch.clamp(span, min=1),
        torch.zeros((), device=values.device))
    interpolated = left_value * (1 - weight) + right_value * weight
    return torch.where(mask, values, interpolated)


def from_alignments(source, target, sample_rate, hopsize, device='cuda'):
    """Grid mapping the frames of a target alignment back onto a source

    Arguments
        source, target: (phonemes, 2) (start, end) seconds of the same
            phonemes in the two alignments
        device: where the grid goes; 'cuda' raises on a host without a
            card

    Returns
        (round(target end * frame rate),) float32 tensor on `device`: for
        each output frame (centred at (i + 0.5) / frame rate), the source
        frame at the same fraction of the same phoneme, floored at 0.
        Computed in float64 numpy, as the JAX package does.
    """
    device = device_module.resolve(device)
    source = np.asarray(source, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if source.shape != target.shape:
        raise ValueError(
            'Source and target alignments must have the same number of '
            'phonemes')
    frames_per_second = sample_rate / hopsize
    total_frames = int(round(target[-1, 1] * frames_per_second))
    times = (np.arange(total_frames) + 0.5) / frames_per_second
    index = np.clip(
        np.searchsorted(target[:, 1], times, side='left'), 0,
        len(target) - 1)
    t0, t1 = target[index, 0], target[index, 1]
    s0, s1 = source[index, 0], source[index, 1]
    alpha = np.where(
        t1 > t0, (times - t0) / np.maximum(t1 - t0, 1e-9), 0.)
    grid = (s0 + alpha * (s1 - s0)) * frames_per_second - 0.5
    return torch.from_numpy(
        np.clip(grid, 0., None).astype(np.float32)).to(device)
