"""Pitch and periodicity from the learned estimator

Counterpart of the 'cnn' front end of `promonet_tpu/preprocess/pitch.py`:
`PitchCNN` scores each 1024-sample frame over 256 log-spaced candidate
frequencies, `decode` Viterbi-decodes the scores (the CUDA kernel of
`ops/viterbi.py` on the card), refines each decoded bin to sub-bin
precision and reads periodicity off the posterior. The NCC ('dsp')
front end is not ported yet.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.modules import Conv1d, same_padding
from ..ops import viterbi

CANDIDATES = 256       # number of log-spaced frequency candidates
TRANSITION_WIDTH = 9.  # triangular transition half-width (bins)
FRAME_SIZE = 1024      # samples per analysis frame


def candidate_frequencies(fmin, fmax, num=CANDIDATES):
    """Log-spaced candidate frequencies in Hz, float32"""
    return np.exp(
        np.linspace(np.log(fmin), np.log(fmax), num)).astype(np.float32)


class PitchCNN(nn.Module):
    """FCNF0-style framewise pitch-posterior CNN

    The JAX model's Flax defaults, written out: every conv pads 'SAME'
    (asymmetric for these even kernels, also when strided), LayerNorm
    epsilon is 1e-6, and the final Dense reads the (T', C) activations
    flattened time-major.
    """

    def __init__(
        self,
        channels=(128, 32, 32, 64, 128, 256),
        kernel_sizes=(32, 16, 8, 8, 8, 4),
        strides=(4, 2, 2, 1, 1, 1),
        num_bins=CANDIDATES
    ):
        super().__init__()
        self.convs = nn.ModuleList()
        length, previous = FRAME_SIZE, 1
        for features, kernel, stride in zip(channels, kernel_sizes, strides):
            self.convs.append(Conv1d(previous, features, kernel, stride=stride))
            previous = features
            length = -(-length // stride)
        self.norms = nn.ModuleList(
            nn.LayerNorm(features, eps=1e-6) for features in channels)
        self.output = nn.Linear(length * previous, num_bins)

    def forward(self, frames):
        """frames (B, FRAME_SIZE) → logits (B, num_bins)"""
        x = frames.float()[..., None]
        for conv, norm in zip(self.convs, self.norms):
            left, right = same_padding(
                x.shape[1], conv.weight.shape[-1], conv.stride)
            x = F.relu(norm(conv(F.pad(x, (0, 0, left, right)))))
        return self.output(x.reshape(x.shape[0], -1))


def posteriorgram(model, audio, hopsize):
    """Per-frame CNN logits (frames, CANDIDATES) of audio (1, T)

    Frames are centered at (i + 0.5) * hopsize and normalized to zero
    mean and unit (population) standard deviation.
    """
    samples = audio[0]
    num_frames = samples.shape[-1] // hopsize
    centers = (np.arange(num_frames) + 0.5) * hopsize
    starts = np.round(centers - FRAME_SIZE / 2).astype(np.int64)
    pad_left = max(0, -int(starts.min()))
    pad_right = max(0, int(starts.max()) + FRAME_SIZE - samples.shape[-1])
    padded = F.pad(samples, (pad_left, pad_right))
    index = (starts + pad_left)[:, None] + np.arange(FRAME_SIZE)[None]
    frames = padded[torch.from_numpy(index).to(padded.device)]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames / torch.clamp(
        frames.std(dim=-1, unbiased=False, keepdim=True), min=1e-6)
    return model(frames)


def decode(scores, fmin, fmax):
    """Viterbi-decode CNN logits (frames, N); returns (pitch, periodicity)

    Sub-bin refinement takes the posterior-weighted mean log frequency
    over the decoded bin ± 4; periodicity is the posterior mass at the
    decoded bin.
    """
    num_states = scores.shape[-1]
    device = scores.device
    log_freqs = torch.log(torch.from_numpy(
        candidate_frequencies(fmin, fmax, num_states)).to(device))
    observation = torch.log_softmax(scores, dim=-1)
    transition = viterbi.triangular_transition(
        num_states, TRANSITION_WIDTH).to(device)
    initial = torch.full(
        (num_states,), -float(np.log(np.float32(num_states))),
        dtype=torch.float32, device=device)
    bins = viterbi.decode(observation, transition, initial).long()

    offsets = torch.arange(-4, 5, device=device)
    neighbors = torch.clamp(bins[:, None] + offsets, 0, num_states - 1)
    weights = torch.softmax(torch.gather(scores, 1, neighbors), dim=-1)
    pitch = torch.exp(torch.sum(weights * log_freqs[neighbors], dim=-1))

    posterior = torch.softmax(scores, dim=-1)
    periodicity = torch.gather(posterior, 1, bins[:, None])[:, 0]
    return pitch, periodicity
