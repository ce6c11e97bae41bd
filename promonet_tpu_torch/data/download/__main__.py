"""python -m promonet_tpu_torch.data.download

Format datasets extracted under config.DATA_DIR into config.CACHE_DIR
(`data.download.datasets`), as `python -m promonet_tpu.data.download`
does. `--config` as the port's other command lines take it; `--gpu` is
accepted and unused (formatting is host work).
"""
from ...utils.cli import ArgumentParser
from .core import datasets


def main():
    parser = ArgumentParser(description='Download and format datasets')
    parser.add_argument(
        '--datasets', nargs='+',
        help='The datasets to format (default: config.DATASETS)')
    args = parser.parse_args()
    datasets(args.datasets, args.config)


if __name__ == '__main__':
    main()
