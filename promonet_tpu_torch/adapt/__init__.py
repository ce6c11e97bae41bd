from .core import normalize_gain, speaker
