from .core import datasets
