from . import harmonics, loudness, pitch, ppg, spectrogram
from .core import from_audio
from .pitch import PitchCNN
from .ppg import PPGEncoder
