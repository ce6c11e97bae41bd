from . import audio, checkpoint, log, notify, pause, timer
