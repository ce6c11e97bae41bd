"""Command-line parsing for the port's `python -m` entry points

Counterpart of `promonet_tpu/utils/cli.py`. The JAX package applies
`--config` files by patching its defaults at import; here the parser
builds a `config.Config` from them (`config.load`) and hands it to the
entry point as `config`. It also turns `--gpu` into the `device` the
entry points take: no `--gpu` is 'cuda', `--gpu N` is 'cuda:N', and
`--gpu -1` is the CPU.
"""
import argparse
from pathlib import Path

from .. import config as config_module


class ArgumentParser(argparse.ArgumentParser):
    """An `argparse.ArgumentParser` that takes `--config` and `--gpu`"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument(
            '--config',
            type=Path,
            nargs='*',
            help='Python configuration file(s) overriding defaults')
        self.add_argument(
            '--gpu',
            type=int,
            help='Index of the GPU to use; -1 runs on the CPU. Without it '
                 'the default CUDA device is used')

    def parse_args(self, *args, **kwargs):
        """The namespace, with `config` a `config.Config` and `device` in
        place of `gpu`"""
        namespace = super().parse_args(*args, **kwargs)
        # The files themselves, for entry points that copy them
        self.config_paths = list(namespace.config or [])
        if namespace.gpu is not None and namespace.gpu < -1:
            self.error(f'--gpu {namespace.gpu}: give an index, or -1 for the '
                       'CPU')
        namespace.config = config_module.load(namespace.config or None)
        namespace.device = device(namespace.gpu)
        del namespace.gpu
        return namespace


def device(gpu):
    """The device of a `--gpu` value"""
    if gpu is None:
        return 'cuda'
    return 'cpu' if gpu == -1 else f'cuda:{gpu}'
