from . import bridge, core, discriminator, init
from . import cargan, export, fargan, vocos, wavlm
from .cargan import CARGAN
from .discriminator import Discriminator
from .generator import Generator, MelGenerator
from .hifigan import HiFiGAN
from .modules import get_padding
from .wavlm import WavLMXVector
