"""Loaders (counterpart of `promonet_tpu/load.py`)

Feature files are the JAX package's: `.npy` arrays, preferred, or
PyTorch `.pt` tensors, read with `torch.load(weights_only=True)`.
"""
from pathlib import Path

import numpy as np
import torch

from . import config as config_module
from . import device as device_module
from .ops import grid
from .utils import audio as audio_module


def array(file):
    """A feature array saved as .npy or .pt, as numpy

    A missing file whose .npy sibling exists is read from the sibling.
    """
    file = Path(file)
    npy = file.with_suffix('.npy')
    if file.suffix == '.npy' or (not file.exists() and npy.exists()):
        return np.load(npy if not file.exists() else file)
    if file.suffix == '.pt':
        return torch.load(
            file, map_location='cpu', weights_only=True).detach().numpy()
    raise FileNotFoundError(file)


def save_array(file, data):
    """Save a feature array: .pt as a tensor, anything else as .npy"""
    file = Path(file)
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    if file.suffix == '.pt':
        torch.save(torch.from_numpy(np.ascontiguousarray(data)), file)
    else:
        np.save(file.with_suffix('.npy'), data)


def audio(file, config=None):
    """A wav file as float32 numpy (1, T), mono, at config.SAMPLE_RATE"""
    config = config_module.default() if config is None else config
    return audio_module.load(file, config.SAMPLE_RATE)[0]


def features(prefix, config=None):
    """Loudness, pitch, periodicity and PPG saved under a file prefix

    Pitch and periodicity carry the '-viterbi' infix when
    config.VITERBI_DECODE_PITCH is set, as `preprocess.save` names them.
    """
    config = config_module.default() if config is None else config
    prefix = str(prefix)
    pitch_prefix = (
        f'{prefix}-viterbi' if config.VITERBI_DECODE_PITCH else prefix)
    return (
        array(f'{prefix}-loudness.npy'),
        array(f'{pitch_prefix}-pitch.npy'),
        array(f'{pitch_prefix}-periodicity.npy'),
        array(f'{prefix}-ppg.npy'))


def ppg(file, resample_length=None, config=None, device='cuda'):
    """A PPG file as a float32 tensor on `device`, maybe resampled to
    `resample_length` frames

    Resampling samples the grid of that length (config.PPG_INTERP_METHOD)
    and normalises each frame again in the log domain, so frames stay
    distributions. Both run on `device`.
    """
    config = config_module.default() if config is None else config
    values = torch.as_tensor(
        array(file), dtype=torch.float32,
        device=device_module.resolve(device))
    if resample_length is None or values.shape[-1] == resample_length:
        return values
    values = grid.sample(
        values, grid.of_length(values, resample_length),
        config.PPG_INTERP_METHOD)
    return torch.exp(
        torch.log(values + 1e-8) -
        torch.log(torch.sum(values + 1e-8, dim=-2, keepdim=True)))


def text(file):
    """The contents of a UTF-8 text file"""
    with open(file, encoding='utf-8') as handle:
        return handle.read()


def pitch_distribution(config=None):
    """Boundaries of the variable-width pitch bins, in Hz

    Reads the statistics file the JAX package ships for the configured
    training dataset. Where there is none, falls back to log-uniform
    quantiles over [FMIN, FMAX], as the JAX function does when it has no
    dataset to compute them from. Unlike the JAX function, this never
    computes or writes the file.
    """
    config = config_module.default() if config is None else config
    key = ''
    if config.AUGMENT_LOUDNESS:
        key += '-loudness'
    if config.AUGMENT_PITCH:
        key += '-pitch'
    if config.VITERBI_DECODE_PITCH:
        key += '-viterbi'
    file = (
        config.ASSETS_DIR / 'stats' /
        f'{config.TRAINING_DATASET}-{config.PITCH_BINS}{key}.npy')
    if file.exists():
        return np.load(file)
    return np.exp(
        np.linspace(
            np.log(config.FMIN),
            np.log(config.FMAX),
            config.PITCH_BINS)).astype(np.float32)
