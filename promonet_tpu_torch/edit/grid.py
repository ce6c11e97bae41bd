"""Interpolation grids for editing (counterpart of `edit/grid.py`)"""
from .. import config as config_module
from ..ops import grid as _grid
from ..ops.grid import constant, of_length, sample  # noqa: F401


def from_alignments(source, target, config=None, device='cuda'):
    """Time-stretch grid converting a source alignment to a target one, at
    config's sample rate and hopsize (see `ops.grid.from_alignments`)"""
    config = config_module.default() if config is None else config
    return _grid.from_alignments(
        source, target, config.SAMPLE_RATE, config.HOPSIZE, device)
