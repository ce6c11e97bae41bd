"""Baseline vocoders (counterpart of `promonet_tpu/baseline`)

`mels` reconstructs speech from spectrograms alone; `world` is the WORLD
DSP vocoder, analysis, edits and synthesis in numpy on the host.
"""
from . import mels, world
