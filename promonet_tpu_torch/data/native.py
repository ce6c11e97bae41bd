"""The native WAV chunk decoder (counterpart of `promonet_tpu/data/native.py`)

`csrc/promonet_io.cpp` decodes the window of a 16-bit PCM wav that a
training crop needs, and a batch of them on its own threads. It is built
with g++ at first use into `build/native/` at the root of the checkout
(a directory that `.gitignore` lists), never at import; a failed build
raises. `wav_chunk_plain` is its plain version: the whole file through
`utils.audio.load`, then the window, zero-filled past either end. Both
give the same bits (int16 / 32768, channels averaged).
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import audio as audio_module

SOURCE = Path(__file__).parent.parent / 'csrc' / 'promonet_io.cpp'
BUILD_DIR = Path(__file__).parent.parent.parent / 'build' / 'native'

_LOCK = threading.Lock()


def library():
    """The loaded decoder, built with g++ if needed"""
    with _LOCK:
        if not hasattr(library, 'cache'):
            digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
            target = BUILD_DIR / f'promonet_io-{digest}.so'
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                partial = target.with_suffix(f'.{os.getpid()}.tmp')
                result = subprocess.run(
                    ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
                     '-pthread', str(SOURCE), '-o', str(partial)],
                    capture_output=True, text=True)
                if result.returncode:
                    raise RuntimeError(
                        f'building {SOURCE.name} failed:\n{result.stderr}')
                os.replace(partial, target)
            lib = ctypes.CDLL(str(target))
            lib.promonet_wav_frames.restype = ctypes.c_int64
            lib.promonet_wav_frames.argtypes = [ctypes.c_char_p]
            lib.promonet_wav_chunk.restype = ctypes.c_int64
            lib.promonet_wav_chunk.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float)]
            lib.promonet_wav_batch.restype = ctypes.c_int32
            lib.promonet_wav_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32]
            library.cache = lib
        return library.cache


def wav_frames(path):
    """Number of audio frames in a 16-bit PCM wav"""
    frames = library().promonet_wav_frames(str(path).encode())
    if frames < 0:
        raise IOError(f'native wav header read failed: {path}')
    return int(frames)


def wav_chunk(path, start, count):
    """(count,) float32 mono samples from frame `start`, zero-filled past
    the file's ends; the window must overlap the file"""
    out = np.empty(count, np.float32)
    got = library().promonet_wav_chunk(
        str(path).encode(), int(start), int(count),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise IOError(f'native wav decode failed: {path}')
    return out


def wav_batch(paths, starts, chunk, threads=8):
    """(len(paths), chunk) float32: `wav_chunk` of each, on `threads`
    native threads"""
    batch = len(paths)
    out = np.empty((batch, chunk), np.float32)
    path_array = (ctypes.c_char_p * batch)(*[str(p).encode() for p in paths])
    start_array = (ctypes.c_int64 * batch)(*[int(s) for s in starts])
    failures = library().promonet_wav_batch(
        path_array, start_array, batch, int(chunk),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(threads))
    if failures:
        raise IOError(f'native wav batch decode: {failures} failures')
    return out


def wav_chunk_plain(path, start, count):
    """The plain version of `wav_chunk`"""
    audio = audio_module.load(path)[0][0]
    out = np.zeros(count, np.float32)
    first, last = max(start, 0), min(start + count, audio.shape[-1])
    if last > first:
        out[first - start:last - start] = audio[first:last]
    return out
