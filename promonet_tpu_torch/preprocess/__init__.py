from . import harmonics, loudness, pitch, ppg, speaker, spectrogram, text
from .core import from_audio, from_file, from_file_to_file, from_files_to_files
from .pitch import PitchCNN
from .ppg import PPGEncoder
from .speaker import SpeakerEncoder
