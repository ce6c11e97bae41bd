from . import audio
