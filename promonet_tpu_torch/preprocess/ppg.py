"""Phonetic posteriorgrams (counterpart of `preprocess/ppg.py`)

`PPGEncoder` is the forward pass of the JAX package's Flax encoder over
log-mels, with Flax's defaults written out: 'SAME' padding, LayerNorm
epsilon 1e-6, and the tanh approximation of GELU.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..models.modules import Conv1d

# 39 CMUdict phonemes + silence
PHONEMES = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'ch', 'd', 'dh',
    'eh', 'er', 'ey', 'f', 'g', 'hh', 'ih', 'iy', 'jh', 'k',
    'l', 'm', 'n', 'ng', 'ow', 'oy', 'p', 'r', 's', 'sh',
    't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', '<silence>']

PHONEME_TO_INDEX_MAPPING = {p: i for i, p in enumerate(PHONEMES)}

SILENCE = '<silence>'

# Voiced phonemes (vowels, semivowels, nasals, voiced obstruents); the
# PPG-aware time stretch may exempt all other frames
VOICED = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'd', 'dh', 'eh', 'er', 'ey',
    'g', 'ih', 'iy', 'jh', 'l', 'm', 'n', 'ng', 'ow', 'oy', 'r', 'uh',
    'uw', 'v', 'w', 'y', 'z', 'zh']


class PPGEncoder(nn.Module):
    """Frame-rate phoneme classifier over log-mels"""

    def __init__(
        self, num_mels=80, channels=256, num_layers=6, num_phonemes=40,
        kernel_size=5
    ):
        super().__init__()
        self.channels = channels
        padding = (kernel_size // 2, kernel_size - 1 - kernel_size // 2)
        self.convs = nn.ModuleList(
            Conv1d(num_mels if i == 0 else channels, channels, kernel_size,
                   padding=padding)
            for i in range(num_layers))
        self.norms = nn.ModuleList(
            nn.LayerNorm(channels, eps=1e-6) for _ in range(num_layers))
        self.output = nn.Linear(channels, num_phonemes)

    def forward(self, mels):
        """mels (B, T, NUM_MELS) → log-posteriors (B, T, num_phonemes)"""
        x = mels.float()
        for conv, norm in zip(self.convs, self.norms):
            y = F.gelu(norm(conv(x)), approximate='tanh')
            x = y if x.shape[-1] != self.channels else x + y
        return torch.log_softmax(self.output(x), dim=-1)
