"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `build/kernels/<name>-<hash>.so` at the root of the checkout (a
directory that `.gitignore` lists), with `nvcc` for Hopper (`sm_90a`).
The library is loaded with ctypes. Building happens at first use, never
at import: hosts without `nvcc` or a card import every module and run
the plain PyTorch versions. The file name carries a hash of the source,
so an edited kernel is never served from a stale library.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).parent.parent / 'csrc'
BUILD_DIR = Path(__file__).parent.parent.parent / 'build' / 'kernels'

FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
    '-Xptxas', '-v')

# Loaded libraries and the compiler's report of each build, by name
_LIBRARIES = {}
_REPORTS = {}
_LOCK = threading.Lock()


def nvcc():
    """Path of the CUDA compiler"""
    candidates = [shutil.which('nvcc')]
    for variable in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(variable):
            candidates.append(os.path.join(os.environ[variable], 'bin', 'nvcc'))
    candidates.append('/usr/local/cuda/bin/nvcc')
    for candidate in candidates:
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _target(name):
    source = SOURCE_DIR / f'{name}.cu'
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return source, BUILD_DIR / f'{name}-{digest}.so'


def build(names):
    """Compile the named kernels, one `nvcc` process each, all at once

    Returns {name: compiler report}; raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    processes = {}
    for name in names:
        source, target = _target(name)
        if target.exists():
            continue
        partial = target.with_suffix(f'.{os.getpid()}.tmp')
        processes[name] = (
            subprocess.Popen(
                [nvcc(), *FLAGS, '-o', str(partial), str(source)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True),
            partial,
            target)
    failures = []
    for name, (process, partial, target) in processes.items():
        report, _ = process.communicate()
        _REPORTS[name] = report
        if process.returncode:
            failures.append(f'{name}:\n{report}')
        else:
            os.replace(partial, target)
    if failures:
        raise RuntimeError('kernel build failed\n' + '\n'.join(failures))
    return {name: _REPORTS.get(name, '') for name in names}


def library(name):
    """The loaded shared library of kernel `name`, built if needed"""
    with _LOCK:
        if name not in _LIBRARIES:
            _, target = _target(name)
            if not target.exists():
                build([name])
            _LIBRARIES[name] = ctypes.CDLL(str(target))
        return _LIBRARIES[name]


def check(status, name):
    """Raise on a non-zero cudaError_t returned by a kernel's C entry"""
    if status:
        raise RuntimeError(f'{name} kernel failed with cudaError_t {status}')
