from . import bridge, init
from . import fargan, vocos
from .generator import Generator
from .hifigan import HiFiGAN
