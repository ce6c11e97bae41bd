from . import audio, checkpoint, log, timer
