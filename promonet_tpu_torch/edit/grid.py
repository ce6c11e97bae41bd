"""Interpolation grids for editing (counterpart of `edit/grid.py`)"""
from ..ops.grid import constant, of_length, sample  # noqa: F401
