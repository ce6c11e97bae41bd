from .core import from_edited_audio, from_features, generate
