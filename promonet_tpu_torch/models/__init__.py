from . import bridge, init
from .generator import Generator
from .hifigan import HiFiGAN
