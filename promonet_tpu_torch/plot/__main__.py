"""python -m promonet_tpu_torch.plot

Counterpart of `python -m promonet_tpu.plot`, with its arguments:

    python -m promonet_tpu_torch.plot --output_file figure.png \
        [--audio_file x.wav] [--prefix cache/x-100] \
        [--target_prefix cache/y-100] [--features audio pitch ...] \
        [--config ...]

Draws on the host (matplotlib, Agg backend); `--gpu` is accepted and
unused.
"""
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import from_file_to_file


def main():
    parser = ArgumentParser(description='Plot speech representation')
    parser.add_argument(
        '--output_file', type=Path, required=True,
        help='The file to save the figure')
    parser.add_argument(
        '--audio_file', type=Path,
        help='The audio file to plot')
    parser.add_argument(
        '--prefix', type=Path,
        help='The cache prefix of the features to plot')
    parser.add_argument(
        '--target_prefix', type=Path,
        help='The cache prefix of target features to overlay')
    parser.add_argument(
        '--features', nargs='+',
        help='The features to plot (default: the configuration\'s '
             'DEFAULT_PLOT_FEATURES)')
    args = parser.parse_args()
    from_file_to_file(
        args.output_file, args.audio_file, args.prefix, args.target_prefix,
        args.features, args.config)


if __name__ == '__main__':
    main()
