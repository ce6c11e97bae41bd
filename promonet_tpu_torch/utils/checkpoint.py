"""The port's checkpoints (counterpart of `promonet_tpu/utils/checkpoint.py`)

Two formats are read. The JAX package's checkpoints are orbax
directories (`_CHECKPOINT_METADATA`, `_METADATA`, `manifest.ocdbt`):
zarr v2 arrays, one per leaf, in an OCDBT key-value store, compressed
with zstd. `load` reads them without JAX or orbax (`utils.ocdbt`,
`utils.zstd`) and returns the tree that the JAX package's `load` returns,
as numpy arrays. The port writes its own format, which `save` writes:

A checkpoint is one file, `<prefix>-<step:08d>.pt`, that `torch.save`
writes: {'params': state dict, 'step': int, 'epoch': int} and any extra
entries: scalars of the JAX checkpoint it came from (the pitch CNN's
calibrated 'voicing_threshold'), or a trainer's state (`train.core`:
the generator's weight-norm (v, g) set under 'trainable' and each
model's optimizer state under 'optimizer'). It holds tensors, numbers
and dicts of them only, so it is read with `torch.load(weights_only=True)`,
and no JAX or orbax is needed.
"""
import json
import math
import os
import pickle
import re
from pathlib import Path

import numpy as np
import torch

from . import ocdbt, zstd


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
    """The payload of a checkpoint: a port file or an orbax directory

    A port file's tensors go to `map_location` (None leaves them where
    they were saved from, the CPU). An orbax directory gives the tree the
    JAX package's `load` restores: dicts, lists for sequences (an optax
    state), None for the leaves orbax skips, numpy arrays of the saved
    dtypes, shapes and bits, and torch.bfloat16 tensors for bfloat16
    leaves (numpy has no bfloat16); `map_location` does not apply.

    Raises ValueError where an orbax directory cannot be read.
    """
    if is_orbax(path):
        return _orbax_tree(Path(path))
    return torch.load(path, map_location=map_location, weights_only=True)


def is_orbax(path):
    """True if `path` is an orbax checkpoint directory"""
    path = Path(path)
    return path.is_dir() and any(
        (path / name).exists()
        for name in ('_CHECKPOINT_METADATA', 'manifest.ocdbt'))


def readable(path):
    """True if the checkpoint parses (its write completed)

    A port file's tensors are mapped, not read; an orbax directory's
    metadata and manifest are parsed, its arrays not read.
    """
    if is_orbax(path):
        try:
            ocdbt.open(path)
            return bool(top_level_keys(path))
        except (OSError, ValueError):
            return False
    try:
        payload = torch.load(
            path, map_location='cpu', weights_only=True, mmap=True)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError):
        return False
    return isinstance(payload, dict) and 'params' in payload


def top_level_keys(path):
    """The payload's keys: a trainer's checkpoint has 'optimizer' and, for
    a generator, 'trainable' beside 'params', 'step' and 'epoch'; a JAX
    trainer's orbax checkpoint has 'opt_state'"""
    if is_orbax(path):
        return {keys[0] for keys, _, _ in _tree_metadata(Path(path))}
    return set(torch.load(
        path, map_location='cpu', weights_only=True, mmap=True))


def prune(directory, keep_interval=20000, keep_latest=3,
          prefixes=('generator', 'discriminator')):
    """Delete old checkpoint files of a run: of each prefix, all but the
    `keep_latest` newest and every multiple of `keep_interval`; only the
    port's `.pt` files are counted and deleted, a JAX checkpoint never"""
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
    """The newest readable checkpoint of `prefix` in `directory`, or None

    `*` in `prefix` stands for the step. Both packages' checkpoints are
    candidates: the port's `<prefix>.pt` files and the JAX package's
    `<prefix>` orbax directories; at an equal step the port's file is
    taken. A newest checkpoint that does not parse (a write cut short) is
    skipped for the newest one that does, as the JAX package's
    `latest_path` does.
    """
    directory = Path(directory)
    if not directory.is_dir():
        return None
    pattern = re.compile(
        '^' + re.escape(prefix).replace(r'\*', r'(\d+)') + r'(\.pt)?$')
    candidates = []
    for entry in directory.iterdir():
        match = pattern.match(entry.name)
        if match and (match.group(2) or is_orbax(entry)):
            candidates.append(
                (int(match.group(1)), bool(match.group(2)), entry))
    for _, _, entry in sorted(candidates, reverse=True):
        if readable(entry):
            return entry
    return None


###############################################################################
# orbax checkpoints
###############################################################################


# orbax's key types in `_METADATA`: a sequence index or a dict key
SEQUENCE_KEY, DICT_KEY = 1, 2
# The zarr v2 dtypes read; bfloat16 is read as its bits
ZARR_DTYPES = {
    '<f4': np.float32, '<f8': np.float64, '<i4': np.int32, '<i8': np.int64,
    '<u4': np.uint32, '|b1': np.bool_, 'bfloat16': np.uint16}


def _tree_metadata(path):
    """[(key tuple, (key types), value type)] of an orbax checkpoint"""
    try:
        with open(path / '_METADATA') as file:
            metadata = json.load(file)
        entries = metadata['tree_metadata'].values()
        if metadata.get('use_zarr3'):
            raise ValueError(f'{path}: zarr3 arrays are not read')
        return [
            (tuple(str(key['key']) for key in entry['key_metadata']),
             tuple(key['key_type'] for key in entry['key_metadata']),
             entry['value_metadata']['value_type'])
            for entry in entries]
    except (OSError, KeyError, TypeError, json.JSONDecodeError) as error:
        raise ValueError(f'{path}: unreadable orbax metadata') from error


def _orbax_tree(path):
    """The tree of an orbax checkpoint directory (see `load`)"""
    store = ocdbt.open(path)
    tree = {}
    for keys, types, value_type in sorted(_tree_metadata(path)):
        if value_type == 'None':
            value = None
        elif value_type in ('np.ndarray', 'jax.Array'):
            value = zarr_array(store, '.'.join(keys), path)
        else:
            raise ValueError(f'{path}: leaf {keys} of type {value_type}')
        _insert(tree, keys, types, value, path)
    return _sequences(tree)


def _insert(tree, keys, types, value, path):
    node = tree
    for depth, (key, key_type) in enumerate(zip(keys, types)):
        if key_type not in (SEQUENCE_KEY, DICT_KEY):
            raise ValueError(f'{path}: key {keys} of type {key_type}')
        # Sequences are built as dicts of int keys, then made lists
        key = int(key) if key_type == SEQUENCE_KEY else key
        if depth == len(keys) - 1:
            node[key] = value
        else:
            node = node.setdefault(key, {})


def _sequences(node):
    if not isinstance(node, dict):
        return node
    children = {key: _sequences(value) for key, value in node.items()}
    if children and all(isinstance(key, int) for key in children):
        if sorted(children) != list(range(len(children))):
            raise ValueError(f'sequence indices {sorted(children)}')
        return [children[index] for index in range(len(children))]
    return children


def zarr_array(store, name, where=''):
    """The zarr v2 array `name` of a key-value store, as numpy

    The store maps '<name>/.zarray' to the array's JSON metadata and
    '<name>/<i>.<j>...' to its chunks, each a zstd frame of one chunk in C
    order (0-d arrays: '<name>/0'). Several chunks are assembled; a
    missing chunk holds `fill_value` (null: zeros). bfloat16 returns a
    torch.bfloat16 tensor.

    Raises ValueError on another compressor, dtype, order, filter or
    zarr format, and on a chunk that is not one whole chunk.
    """
    what = f'{where}:{name}'
    try:
        meta = json.loads(store[f'{name}/.zarray'.encode()])
        shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    except (KeyError, TypeError, json.JSONDecodeError) as error:
        raise ValueError(f'{what}: no readable .zarray') from error
    if meta.get('zarr_format') != 2 or meta.get('order') != 'C' or \
            meta.get('filters') or \
            (meta.get('compressor') or {}).get('id') != 'zstd' or \
            meta.get('dtype') not in ZARR_DTYPES or \
            meta.get('dimension_separator', '.') not in ('.', '/'):
        raise ValueError(f'{what}: unsupported zarr metadata {meta}')
    separator = meta.get('dimension_separator', '.')
    if len(shape) != len(chunks) or any(size < 1 for size in chunks):
        raise ValueError(f'{what}: chunks {chunks} for shape {shape}')
    dtype = np.dtype(ZARR_DTYPES[meta['dtype']])
    out = np.empty(shape, dtype)
    out[...] = _fill(meta.get('fill_value'), meta['dtype'], dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(size / chunk)) for size, chunk in zip(
        shape, chunks)]
    for index in np.ndindex(*(len(axis) for axis in grid)):
        key = f'{name}/{separator.join(map(str, index)) or "0"}'.encode()
        if key not in store:
            continue
        data = zstd.decompress(store[key], chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(
                f'{what}: chunk {index} holds {len(data)} bytes, not '
                f'{chunk_bytes}')
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(
            slice(i * size, min((i + 1) * size, extent))
            for i, size, extent in zip(index, chunks, shape))
        out[region] = chunk[tuple(
            slice(0, part.stop - part.start) for part in region)]
    if meta['dtype'] == 'bfloat16':
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _fill(value, zarr_dtype, dtype):
    """A zarr v2 fill value as one element of `dtype`"""
    if value is None:
        return 0
    if isinstance(value, str):
        names = {'NaN': math.nan, 'Infinity': math.inf,
                 '-Infinity': -math.inf}
        if value not in names:
            raise ValueError(f'zarr fill value {value!r}')
        value = names[value]
    if zarr_dtype == 'bfloat16':
        return torch.tensor(value, dtype=torch.bfloat16).view(
            torch.int16).item() & 0xFFFF
    return np.asarray(value, dtype)
