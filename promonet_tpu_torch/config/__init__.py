"""Configuration of the PyTorch port.

The JAX package patches its defaults module in place when it is
imported. The port instead builds an explicit `Config` object that
callers pass around: `load()` starts from `defaults.py`, applies the
override files named by the argument or by the
`PROMONET_TPU_TORCH_CONFIG` environment variable (a ':'-separated path
list), then computes the derived values of `static.py`. Override files
are the JAX package's own: plain Python modules that declare
`MODULE = 'promonet_tpu'` (or `'promonet'`) and UPPERCASE constants.
"""
import functools
import importlib.util
import os
import types
from pathlib import Path

from . import defaults, static

# Package names an override file may declare in `MODULE`
MODULES = ('promonet_tpu_torch', 'promonet_tpu', 'promonet')

ENVIRONMENT_VARIABLE = 'PROMONET_TPU_TORCH_CONFIG'


class Config(types.SimpleNamespace):
    """Resolved configuration: UPPERCASE attributes, treated as read-only"""

    def replace(self, **overrides):
        """A new configuration with `overrides` applied and re-derived"""
        return _resolve({**self._given, **overrides})


def load(paths=None):
    """Build a configuration from the defaults and override files

    Arguments
        paths: override files, applied in order; None reads
            PROMONET_TPU_TORCH_CONFIG
    """
    if paths is None:
        paths = [
            path for path in
            os.environ.get(ENVIRONMENT_VARIABLE, '').split(':') if path]
    elif isinstance(paths, (str, Path)):
        paths = [paths]
    values = {
        name: getattr(defaults, name)
        for name in dir(defaults) if name.isupper()}
    for path in paths:
        module = _execute(path)
        if getattr(module, 'MODULE', None) not in MODULES:
            continue
        values.update({
            name: getattr(module, name)
            for name in dir(module) if name.isupper() and name != 'MODULE'})
    return _resolve(values)


@functools.lru_cache(maxsize=1)
def default():
    """The configuration of the environment, loaded once per process"""
    return load()


def _execute(path):
    path = Path(path)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _resolve(given):
    """Config of the given (default or overridden) values plus derived ones

    A directory (a name ending in _DIR) given as a string becomes a Path.
    """
    given = {
        name: Path(value) if name.endswith('_DIR') and isinstance(
            value, str) else value
        for name, value in given.items()
        if name not in static.DERIVED}
    return Config(**given, **static.derive(given), _given=given)
