"""1-D grid resampling (counterpart of `promonet_tpu/ops/grid.py`)"""
import torch


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
