from .core import from_features, generate
