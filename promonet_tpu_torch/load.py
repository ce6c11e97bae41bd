"""Read-only loaders (counterpart of part of `promonet_tpu/load.py`)"""
import numpy as np

from . import config as config_module


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
