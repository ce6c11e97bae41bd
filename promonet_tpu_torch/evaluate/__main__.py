"""python -m promonet_tpu_torch.evaluate

Counterpart of `python -m promonet_tpu.evaluate`, with its arguments:

    python -m promonet_tpu_torch.evaluate [--datasets synthetic ...] \
        [--checkpoint generator.pt] [--max_stems N] [--config ...] \
        [--gpu N]

Results go to config.RESULTS_DIR, artefacts to config.EVAL_DIR
(`evaluate.datasets`). `--gpu -1` runs on the CPU. `--adapt` is refused
with exit code 2: adaptation trains a generator per speaker, and training
is not ported yet.
"""
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import datasets


def parse_args():
    parser = ArgumentParser(description='Perform objective evaluation')
    parser.add_argument(
        '--datasets', nargs='+',
        help='The datasets to evaluate (default: the training dataset)')
    parser.add_argument(
        '--checkpoint', type=Path,
        help='The generator checkpoint: a port checkpoint file, or a '
             'directory of them')
    parser.add_argument(
        '--max_stems', type=int,
        help='Evaluate at most this many utterances per speaker')
    parser.add_argument(
        '--adapt', action='store_true',
        help='Not available: adaptation trains a generator per speaker, '
             'and training is not ported yet')
    args = parser.parse_args()
    if args.adapt:
        parser.error(
            '--adapt trains a generator per speaker; training is not '
            'ported yet (ROADMAP.md §1 item 3)')
    del args.adapt
    return args


if __name__ == '__main__':
    datasets(**vars(parse_args()))
