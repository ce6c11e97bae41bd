"""python -m promonet_tpu_torch.models.export

Export a generator checkpoint's packed-inference program
(`models.export.from_file_to_file`). Arguments as the JAX package's
`python -m promonet_tpu.models.export`, with `--config` and `--gpu` as
the port's other command lines take them.
"""
from pathlib import Path

from ...utils.cli import ArgumentParser
from .core import from_file_to_file


def main():
    parser = ArgumentParser(description='Export a model for deployment')
    parser.add_argument(
        '--checkpoint', type=Path, required=True,
        help='The generator checkpoint to export')
    parser.add_argument(
        '--output_file', type=Path, required=True,
        help='The export path, minus extension')
    args = parser.parse_args()
    from_file_to_file(
        args.checkpoint, args.output_file, config=args.config,
        device=args.device)


if __name__ == '__main__':
    main()
