"""Baseline vocoders (counterpart of `promonet_tpu/baseline`)

`mels` reconstructs speech from spectrograms alone. The WORLD baseline
(`promonet_tpu/baseline/world.py`) is not ported.
"""
from . import mels
