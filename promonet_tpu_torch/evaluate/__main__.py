"""python -m promonet_tpu_torch.evaluate

Counterpart of `python -m promonet_tpu.evaluate`, with its arguments:

    python -m promonet_tpu_torch.evaluate [--datasets synthetic ...] \
        [--checkpoint generator.pt] [--max_stems N] [--adapt] \
        [--config ...] [--gpu N]

Results go to config.RESULTS_DIR, artefacts to config.EVAL_DIR
(`evaluate.datasets`). `--gpu -1` runs on the CPU. `--adapt` adapts the
generator to each speaker of the dataset's adaptation partition first.
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
        help='Adapt the generator to each speaker of the adaptation '
             'partition before evaluating it')
    return parser.parse_args()


if __name__ == '__main__':
    datasets(**vars(parse_args()))
