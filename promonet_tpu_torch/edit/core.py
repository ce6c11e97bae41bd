"""Edit speech features (counterpart of `promonet_tpu/edit/core.py`)

Pitch shift, constant-ratio time stretch and loudness scale, on
exact-length features. The PPG-aware selective stretch
(`_selective_grid` in the JAX package) is not ported yet.
"""
from typing import Optional

import numpy as np
import torch

from .. import config as config_module
from .. import convert
from . import grid as grid_module


def from_features(
    loudness,
    pitch,
    periodicity,
    ppg,
    pitch_shift_cents: Optional[float] = None,
    time_stretch_ratio: Optional[float] = None,
    loudness_scale_db: Optional[float] = None,
    stretch_unvoiced: bool = True,
    stretch_silence: bool = True,
    return_grid: bool = False,
    config=None
):
    """Edit speech representation

    Arguments
        loudness: (F, T) loudness contour
        pitch: (1, T) pitch contour in Hz
        periodicity: (1, T) periodicity contour
        ppg: (C, T) phonetic posteriorgram
        pitch_shift_cents: amount of pitch shifting in cents
        time_stretch_ratio: amount of time stretching; faster above one
        loudness_scale_db: loudness scaling in dB
        stretch_unvoiced / stretch_silence: must stay True; the
            selective stretch is not ported
        return_grid: also return the time-stretch grid
        config: a `config.Config`; None reads the environment's

    Returns
        edited loudness, pitch, periodicity and ppg as float32 tensors on
        the device of the inputs (+ the grid if return_grid)
    """
    config = config_module.default() if config is None else config
    if not (stretch_unvoiced and stretch_silence):
        raise NotImplementedError('The selective time stretch is not ported')
    loudness, pitch, periodicity, ppg = (
        torch.as_tensor(np.asarray(x, np.float32))
        if not isinstance(x, torch.Tensor) else x.float()
        for x in (loudness, pitch, periodicity, ppg))
    grid = None
    shift_ratio = (
        convert.cents_to_ratio(pitch_shift_cents)
        if pitch_shift_cents is not None else 1.)
    scale_db = loudness_scale_db if loudness_scale_db is not None else 0.

    if time_stretch_ratio is not None:
        grid = grid_module.constant(ppg, time_stretch_ratio)
        pitch = 2 ** grid_module.sample(torch.log2(pitch), grid)
        periodicity = grid_module.sample(periodicity, grid)
        loudness = grid_module.sample(loudness, grid)
        ppg = grid_module.sample(ppg, grid, config.PPG_INTERP_METHOD)
    if time_stretch_ratio is not None or pitch_shift_cents is not None \
            or loudness_scale_db is not None:
        # The JAX package rounds both amounts to float32 scalars
        pitch = pitch * torch.tensor(
            shift_ratio, dtype=torch.float32, device=pitch.device)
        if pitch_shift_cents is not None:
            pitch = torch.clamp(pitch, config.FMIN, config.FMAX)
        loudness = loudness + torch.tensor(
            scale_db, dtype=torch.float32, device=loudness.device)

    if return_grid:
        return loudness, pitch, periodicity, ppg, grid
    return loudness, pitch, periodicity, ppg
