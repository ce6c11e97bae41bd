"""Figures: prosody panels (`from_features`, `from_file_to_file`) and
speaker-embedding clusters (`speaker.from_embeddings` over `umap.UMAP`)"""
from .core import from_features, from_file_to_file
from . import speaker, umap
