from . import core
from .core import (
    PEAK_TARGET, daps, datasets, format_generic, libritts, normalize_gain,
    vctk)
