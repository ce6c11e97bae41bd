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
