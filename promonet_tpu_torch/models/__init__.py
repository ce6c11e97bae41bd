from . import bridge, core, discriminator, init
from . import fargan, vocos
from .discriminator import Discriminator
from .generator import Generator, MelGenerator
from .hifigan import HiFiGAN
