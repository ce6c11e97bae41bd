from . import audio, checkpoint, timer
