"""python -m promonet_tpu_torch.edit

Counterpart of `python -m promonet_tpu.edit`, with its arguments and file
names, and `--gpu` besides (`--gpu -1` runs on the CPU):

    python -m promonet_tpu_torch.edit --loudness_files ... \
        --pitch_files ... --periodicity_files ... --ppg_files ... \
        --output_prefixes ... [--pitch_shift_cents C] \
        [--time_stretch_ratio R] [--loudness_scale_db D] [--config ...]
"""
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import from_files_to_files


def parse_args():
    parser = ArgumentParser(description='Edit speech representation')
    parser.add_argument(
        '--loudness_files', type=Path, nargs='+', required=True,
        help='The loudness files to edit')
    parser.add_argument(
        '--pitch_files', type=Path, nargs='+', required=True,
        help='The pitch files to edit')
    parser.add_argument(
        '--periodicity_files', type=Path, nargs='+', required=True,
        help='The periodicity files to edit')
    parser.add_argument(
        '--ppg_files', type=Path, nargs='+', required=True,
        help='The phonetic posteriorgram files to edit')
    parser.add_argument(
        '--output_prefixes', type=Path, nargs='+', required=True,
        help='The locations to save output files, minus extension')
    parser.add_argument(
        '--pitch_shift_cents', type=float,
        help='Amount of pitch-shifting in cents')
    parser.add_argument(
        '--time_stretch_ratio', type=float,
        help='Amount of time-stretching. Faster when above one.')
    parser.add_argument(
        '--loudness_scale_db', type=float,
        help='Loudness scaling in decibels')
    parser.add_argument(
        '--stretch_unvoiced', action='store_true', default=True,
        help='If set, time-stretches unvoiced frames')
    parser.add_argument(
        '--no-stretch_unvoiced', dest='stretch_unvoiced',
        action='store_false',
        help='If set, does not time-stretch unvoiced frames')
    parser.add_argument(
        '--stretch_silence', action='store_true', default=True,
        help='If set, time-stretches silent frames')
    parser.add_argument(
        '--no-stretch_silence', dest='stretch_silence',
        action='store_false',
        help='If set, does not time-stretch silent frames')
    parser.add_argument(
        '--save_grid', action='store_true',
        help='If set, also saves the time-stretch grid')
    return parser.parse_args()


if __name__ == '__main__':
    from_files_to_files(**vars(parse_args()))
