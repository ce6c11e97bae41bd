from . import metrics
from .core import datasets, speaker
from .metrics import Metrics
