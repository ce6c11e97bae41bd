"""The port's checkpoints (counterpart of `promonet_tpu/utils/checkpoint.py`)

A checkpoint is one file, `<prefix>-<step:08d>.pt`, that `torch.save`
writes: {'params': state dict, 'step': int, 'epoch': int} and any extra
entries: scalars of the JAX checkpoint it came from (the pitch CNN's
calibrated 'voicing_threshold'), or a trainer's state (`train.core`:
the generator's weight-norm (v, g) set under 'trainable' and each
model's optimizer state under 'optimizer'). It holds tensors, numbers
and dicts of them only, so it is read with `torch.load(weights_only=True)`,
and no JAX or orbax is needed.
"""
import os
import pickle
import re
from pathlib import Path

import torch


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {key: _to_cpu(item) for key, item in value.items()}
    return value


def save(path, params, step=0, epoch=0, **extra):
    """Write a checkpoint file; the write is atomic

    Arguments
        path: the file to write
        params: a state dict; its tensors are saved from the CPU
        step, epoch: training counters
        extra: further ints, floats, tensors or dicts of them to keep
            beside them (tensors from the CPU)
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        'params': _to_cpu(params),
        'step': int(step),
        'epoch': int(epoch),
        **_to_cpu(extra)}
    partial = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    torch.save(payload, partial)
    os.replace(partial, path)


def load(path, map_location=None):
    """The payload of a checkpoint file, tensors on `map_location`

    None leaves the tensors where they were saved from (the CPU).
    """
    return torch.load(path, map_location=map_location, weights_only=True)


def readable(path):
    """True if the file parses as a checkpoint (its write completed)

    The tensors' data is mapped, not read.
    """
    try:
        payload = torch.load(
            path, map_location='cpu', weights_only=True, mmap=True)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError):
        return False
    return isinstance(payload, dict) and 'params' in payload


def top_level_keys(path):
    """The payload's keys: a trainer's checkpoint has 'optimizer' and, for
    a generator, 'trainable' beside 'params', 'step' and 'epoch'"""
    return set(torch.load(
        path, map_location='cpu', weights_only=True, mmap=True))


def prune(directory, keep_interval=20000, keep_latest=3,
          prefixes=('generator', 'discriminator')):
    """Delete old checkpoints of a run: of each prefix, all but the
    `keep_latest` newest and every multiple of `keep_interval`"""
    directory = Path(directory)
    if not directory.is_dir():
        return
    for prefix in prefixes:
        pattern = re.compile(f'^{re.escape(prefix)}-(\\d+)\\.pt$')
        entries = sorted(
            (int(match.group(1)), entry) for entry in directory.iterdir()
            if (match := pattern.match(entry.name)))
        for step, entry in entries[:-keep_latest or None]:
            if keep_interval and step % keep_interval == 0:
                continue
            entry.unlink(missing_ok=True)


def latest_path(directory, prefix='generator-*'):
    """The newest readable `<prefix>.pt` in `directory`, or None

    `*` in `prefix` stands for the step. A newest file that does not
    parse (a write cut short) is skipped for the newest one that does, as
    the JAX package's `latest_path` does.
    """
    directory = Path(directory)
    if not directory.is_dir():
        return None
    pattern = re.compile(
        '^' + re.escape(prefix).replace(r'\*', r'(\d+)') + r'\.pt$')
    candidates = []
    for entry in directory.iterdir():
        match = pattern.match(entry.name)
        if match:
            candidates.append((int(match.group(1)), entry))
    for _, entry in sorted(candidates, reverse=True):
        if readable(entry):
            return entry
    return None
