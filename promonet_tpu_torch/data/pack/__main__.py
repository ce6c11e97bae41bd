"""python -m promonet_tpu_torch.data.pack

Pack the features under cache prefixes into frame-rate tensors
(`data.pack.from_file_to_file`); the JAX package's arguments, with
`--config`.
"""
from pathlib import Path

from ...utils.cli import ArgumentParser
from .core import from_file_to_file


def main():
    parser = ArgumentParser(
        description='Pack features into a single frame-rate tensor')
    parser.add_argument(
        '--prefixes', type=Path, nargs='+', required=True,
        help='The cache prefixes of the features to pack')
    parser.add_argument(
        '--output_files', type=Path, nargs='+', required=True,
        help='The files to save packed features (.npy or .csv)')
    parser.add_argument(
        '--speaker', type=int, default=0, help='The speaker index')
    args = parser.parse_args()
    for prefix, output_file in zip(args.prefixes, args.output_files):
        from_file_to_file(
            prefix, output_file, config=args.config, speaker=args.speaker)


if __name__ == '__main__':
    main()
