"""Edit speech features (counterpart of `promonet_tpu/edit/core.py`)

Pitch shift, time stretch and loudness scale, on exact-length features.
The stretch is constant-ratio, or PPG-aware: `stretch_unvoiced=False` or
`stretch_silence=False` exempt those frames, and the variable-rate grid
is then built on the host from the PPG (`_selective_grid`), because it
decides the output length. The `from_file*` functions read and write the
feature files of `preprocess.save`, and edit on `device`.
"""
import math
from typing import Optional

import numpy as np
import torch

from .. import config as config_module
from .. import convert
from .. import device as device_module
from .. import load
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


def from_file(
    loudness_file,
    pitch_file,
    periodicity_file,
    ppg_file,
    pitch_shift_cents=None,
    time_stretch_ratio=None,
    loudness_scale_db=None,
    stretch_unvoiced=True,
    stretch_silence=True,
    return_grid=False,
    config=None,
    device='cuda'
):
    """Edit features on disk; see `from_features`

    The arrays are moved to `device` ('cuda' raises on a host without a
    card) and edited there. The PPG is resampled to the pitch's frame
    count (`load.ppg`).
    """
    config = config_module.default() if config is None else config
    device = device_module.resolve(device)
    loudness, pitch, periodicity = (
        torch.as_tensor(load.array(file), dtype=torch.float32, device=device)
        for file in (loudness_file, pitch_file, periodicity_file))
    return from_features(
        loudness,
        pitch,
        periodicity,
        load.ppg(ppg_file, pitch.shape[-1], config, device),
        pitch_shift_cents,
        time_stretch_ratio,
        loudness_scale_db,
        stretch_unvoiced,
        stretch_silence,
        return_grid,
        config)


def from_file_to_file(
    loudness_file,
    pitch_file,
    periodicity_file,
    ppg_file,
    output_prefix,
    pitch_shift_cents=None,
    time_stretch_ratio=None,
    loudness_scale_db=None,
    stretch_unvoiced=True,
    stretch_silence=True,
    save_grid=False,
    config=None,
    device='cuda'
):
    """Edit features on disk and save them under `output_prefix`

    Names are those of `preprocess.save`; with save_grid the time-stretch
    grid goes to `{output_prefix}-grid.npy`.
    """
    config = config_module.default() if config is None else config
    results = from_file(
        loudness_file, pitch_file, periodicity_file, ppg_file,
        pitch_shift_cents, time_stretch_ratio, loudness_scale_db,
        stretch_unvoiced, stretch_silence, save_grid, config, device)
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    load.save_array(f'{output_prefix}-loudness.npy', results[0])
    load.save_array(f'{output_prefix}{viterbi}-pitch.npy', results[1])
    load.save_array(f'{output_prefix}{viterbi}-periodicity.npy', results[2])
    load.save_array(f'{output_prefix}-ppg.npy', results[3])
    if save_grid:
        load.save_array(f'{output_prefix}-grid.npy', results[4])


def from_files_to_files(
    loudness_files,
    pitch_files,
    periodicity_files,
    ppg_files,
    output_prefixes,
    pitch_shift_cents=None,
    time_stretch_ratio=None,
    loudness_scale_db=None,
    stretch_unvoiced=True,
    stretch_silence=True,
    save_grid=False,
    config=None,
    device='cuda'
):
    """Edit several sets of features on disk, in turn"""
    for files in zip(
        loudness_files, pitch_files, periodicity_files, ppg_files,
        output_prefixes
    ):
        from_file_to_file(
            *files,
            pitch_shift_cents=pitch_shift_cents,
            time_stretch_ratio=time_stretch_ratio,
            loudness_scale_db=loudness_scale_db,
            stretch_unvoiced=stretch_unvoiced,
            stretch_silence=stretch_silence,
            save_grid=save_grid,
            config=config,
            device=device)


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
