"""python -m promonet_tpu_torch.synthesize

Counterpart of `python -m promonet_tpu.synthesize`, with its arguments
and file names:

    python -m promonet_tpu_torch.synthesize --loudness_files ... \
        --pitch_files ... --periodicity_files ... --ppg_files ... \
        --output_files ... [--speakers ...] [--checkpoint generator.pt] \
        [--config ...] [--gpu N]

`--checkpoint` is a port checkpoint file or a directory of them
(`load.generator`); without it the generator resolves as the JAX
package's does. `--gpu -1` runs on the CPU. `--precompile` is refused:
it warms the JAX package's TPU compile cache, which the port has no
counterpart of.
"""
from pathlib import Path

from .. import load
from ..utils.cli import ArgumentParser
from .core import from_files_to_files

REQUIRED = (
    'loudness_files', 'pitch_files', 'periodicity_files', 'ppg_files',
    'output_files')


def parse_args():
    parser = ArgumentParser(description='Synthesize speech from features')
    parser.add_argument(
        '--precompile', action='store_true',
        help='Not available: it warms the TPU compile cache of the JAX '
             'package, and the PyTorch port has none')
    parser.add_argument(
        '--loudness_files', type=Path, nargs='+',
        help='The loudness files')
    parser.add_argument(
        '--pitch_files', type=Path, nargs='+',
        help='The pitch files')
    parser.add_argument(
        '--periodicity_files', type=Path, nargs='+',
        help='The periodicity files')
    parser.add_argument(
        '--ppg_files', type=Path, nargs='+',
        help='The phonetic posteriorgram files')
    parser.add_argument(
        '--output_files', type=Path, nargs='+',
        help='The files to save the synthesized audio')
    parser.add_argument(
        '--speakers', type=int, nargs='+',
        help='The IDs of the speakers for voice conversion')
    parser.add_argument(
        '--spectral_balance_ratio', type=float, default=1.,
        help='> 1 for Alvin and the Chipmunks; < 1 for Patrick Star')
    parser.add_argument(
        '--loudness_ratio', type=float, default=1.,
        help='> 1 for louder; < 1 for quieter')
    parser.add_argument(
        '--checkpoint', type=Path,
        help='The generator checkpoint: a port checkpoint file, or a '
             'directory of them')
    args = parser.parse_args()
    if args.precompile:
        parser.error(
            '--precompile warms the TPU compile cache of the JAX package '
            '(promonet_tpu.synthesize.precompile); the PyTorch port has no '
            'compile cache to warm')
    del args.precompile
    missing = [name for name in REQUIRED if getattr(args, name) is None]
    if missing:
        parser.error(
            'the following arguments are required: ' +
            ', '.join(f'--{name}' for name in missing))
    return args


def main(checkpoint, config, device, **arguments):
    """Synthesize the feature files with the resolved generator"""
    from_files_to_files(
        generator=load.generator(checkpoint, config, device), device=device,
        **arguments)


if __name__ == '__main__':
    main(**vars(parse_args()))
