from . import audio, checkpoint
