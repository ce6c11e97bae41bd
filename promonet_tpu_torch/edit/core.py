"""Edit speech features (counterpart of `promonet_tpu/edit/core.py`)

Pitch shift, time stretch and loudness scale, on exact-length features.
The stretch is constant-ratio, or PPG-aware: `stretch_unvoiced=False` or
`stretch_silence=False` exempt those frames, and the variable-rate grid
is then built on the host from the PPG (`_selective_grid`), because it
decides the output length.
"""
import math
from typing import Optional

import numpy as np
import torch

from .. import config as config_module
from .. import convert
from ..preprocess.ppg import (
    PHONEME_TO_INDEX_MAPPING, PHONEMES, SILENCE, VOICED)
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
        stretch_unvoiced: if False, unvoiced frames keep their duration
        stretch_silence: if False, silent frames keep their duration
        return_grid: also return the time-stretch grid
        config: a `config.Config`; None reads the environment's

    Returns
        edited loudness, pitch, periodicity and ppg as float32 tensors on
        the device of the inputs (+ the grid if return_grid)
    """
    config = config_module.default() if config is None else config
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
        if stretch_unvoiced and stretch_silence:
            grid = grid_module.constant(ppg, time_stretch_ratio)
        else:
            grid = torch.from_numpy(_selective_grid(
                ppg.detach().cpu().numpy(),
                time_stretch_ratio,
                stretch_unvoiced,
                stretch_silence)).to(ppg.device)
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


def _selective_grid(ppg, ratio, stretch_unvoiced, stretch_silence):
    """Variable-rate stretch grid exempting unvoiced and/or silent frames

    Arguments
        ppg: (PPG_CHANNELS, T) numpy posteriorgram

    Returns
        grid: (round(T / ratio),) float32 numpy positions. Each step is
        1 / (p * r + 1 - p) input frames, with p the probability that the
        frame at the current position is stretchable and r the ratio that
        makes the selected frames absorb the whole change of length.
    """
    # Phoneme classes selected FOR stretching
    indices = [PHONEME_TO_INDEX_MAPPING[phoneme] for phoneme in VOICED]
    if stretch_silence:
        indices.append(PHONEME_TO_INDEX_MAPPING[SILENCE])
    if stretch_unvoiced:
        indices.extend(
            PHONEME_TO_INDEX_MAPPING[phoneme] for phoneme in PHONEMES
            if phoneme not in VOICED and phoneme != SILENCE)
    selected = ppg[np.asarray(indices)].sum(axis=0)

    total_frames = ppg.shape[-1]
    target_frames = round(total_frames / ratio)
    total_selected = selected.sum()
    total_unselected = total_frames - total_selected
    effective_ratio = (target_frames - total_unselected) / total_selected

    grid = np.zeros(target_frames, dtype=np.float32)
    i = 0.
    for j in range(1, target_frames):
        left = math.floor(i)
        if left + 1 < len(selected):
            offset = i - left
            probability = (
                offset * selected[left + 1] + (1 - offset) * selected[left])
        else:
            probability = selected[left]
        frame_ratio = probability * effective_ratio + (1 - probability)
        step = 1. / frame_ratio
        grid[j] = grid[j - 1] + step
        i += step
    return grid
