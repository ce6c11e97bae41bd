from . import bridge, init
from . import fargan, vocos
from .generator import Generator, MelGenerator
from .hifigan import HiFiGAN
