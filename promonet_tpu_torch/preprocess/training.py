"""What the trainings of the feature extractors share

The pitch CNN (`pitch.train`), the PPG encoder (`ppg.train`) and the
speaker encoder (`speaker.train`) train on the formant corpus's ground
truth, as the JAX package's do. Each draws every random choice (kept
frames, tones, the held-out split, each batch's indices) on the host from
one `numpy.random.default_rng(RANDOM_SEED)`, in the JAX package's order,
uploads its example bank to the training device once and gathers each
batch there, and writes `<name>-<steps:08d>.pt` that `load` reads.
"""
import math
from pathlib import Path

import numpy as np
import torch

from . import spectrogram


def adamw_cosine(parameters, learning_rate, steps, weight_decay=1e-4):
    """`optax.adamw(cosine_decay_schedule(learning_rate, steps),
    weight_decay)`: AdamW (b1 0.9, b2 0.999, eps 1e-8) whose step t
    (from 0) takes learning_rate * (1 + cos(pi * min(t, steps) / steps)) / 2,
    with the decay on every parameter

    Returns the optimizer and its schedule, stepped after each update.
    """
    optimizer = torch.optim.AdamW(
        parameters, lr=learning_rate, betas=(.9, .999), eps=1e-8,
        weight_decay=weight_decay)
    steps = max(steps, 1)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda step: .5 * (1 + math.cos(math.pi * min(step, steps) / steps)))
    return optimizer, schedule


def update(loss, optimizer, schedule=None):
    """One optimizer step on `loss`; returns the loss, detached"""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    if schedule is not None:
        schedule.step()
    return loss.detach()


def batches(rng, population, batch_size, steps, device):
    """Each step's `rng.choice(population, batch_size)`, drawn in turn as
    the JAX package draws them one step at a time, as one (steps,
    batch_size) int64 tensor on `device`: one upload, and no copy from
    the host between steps"""
    return torch.from_numpy(np.array(
        [rng.choice(population, batch_size) for _ in range(steps)],
        np.int64).reshape(steps, batch_size)).to(device)


def window_mels(audio, frames, window, config, device):
    """Log-mels of `frames` frames of audio (1, T), zero-padded to whole
    windows: float32 numpy (padded frames, NUM_MELS), computed on
    `device`"""
    hopsize = config.HOPSIZE
    padded_frames = -(-frames // window) * window
    audio = np.pad(
        audio[:, :frames * hopsize],
        ((0, 0), (0, (padded_frames - frames) * hopsize)))
    with torch.no_grad():
        mels = spectrogram.from_audio(
            torch.from_numpy(audio).to(device), config, mels=True)
    return mels.T[:padded_frames].cpu().numpy()


def checkpoint_file(name, steps, output, config):
    """`<name>-<steps:08d>.pt` in `output`, or in config.CHECKPOINTS_DIR"""
    directory = config.CHECKPOINTS_DIR if output is None else output
    return Path(directory) / f'{name}-{steps:08d}.pt'
