"""Segment slicing (counterpart of `promonet_tpu/models/core.py`)"""
import torch


def slice_segments(segments, start_indices, segment_size, fill_value=0.):
    """Windows of `segment_size` along the last axis, one start per example

    A negative start reads `fill_value` before the segment; a start past
    the end is clamped so the window fits, as `jax.lax.dynamic_slice`
    clamps it.

    Arguments
        segments: (B, ..., T)
        start_indices: (B,) integer starts
    """
    padded = torch.cat((
        torch.full(
            (*segments.shape[:-1], segment_size), fill_value,
            dtype=segments.dtype, device=segments.device),
        segments), dim=-1)
    starts = torch.clamp(
        start_indices.long() + segment_size, 0,
        padded.shape[-1] - segment_size)
    index = starts[:, None] + torch.arange(
        segment_size, device=segments.device)
    index = index.reshape(
        index.shape[0], *([1] * (segments.dim() - 2)), segment_size)
    return torch.gather(
        padded, -1, index.expand(*segments.shape[:-1], segment_size))


def random_slice_segments(segments, lengths, segment_size, generator=None):
    """Random windows: starts uniform in [0, lengths - segment_size], drawn
    from `generator` (a `torch.Generator` on the segments' device); returns
    (windows, starts)"""
    max_start = lengths - segment_size + 1
    uniform = torch.rand(
        segments.shape[0], generator=generator, device=segments.device)
    start_indices = (uniform * max_start).int()
    return slice_segments(segments, start_indices, segment_size), \
        start_indices
