from . import grid
from .core import from_features
