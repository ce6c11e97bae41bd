"""python -m promonet_tpu_torch.adapt

Counterpart of `python -m promonet_tpu.adapt`:

    python -m promonet_tpu_torch.adapt --name <speaker> \
        --files a.wav b.wav ... [--checkpoint generator.pt] \
        [--config ...] [--gpu N]
"""
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import speaker


def parse_args():
    parser = ArgumentParser(description='Perform speaker adaptation')
    parser.add_argument(
        '--name', required=True, help='The name of the speaker')
    parser.add_argument(
        '--files', type=Path, nargs='+', required=True,
        help='The audio files of the target speaker')
    parser.add_argument(
        '--checkpoint', type=Path,
        help='The base generator checkpoint to adapt from')
    return parser.parse_args()


if __name__ == '__main__':
    speaker(**vars(parse_args()))
