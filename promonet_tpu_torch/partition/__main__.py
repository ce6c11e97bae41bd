"""python -m promonet_tpu_torch.partition

Partition datasets (`partition.datasets`), as `python -m
promonet_tpu.partition` does; the partitions go to
config.PARTITIONS_DIR. `--config` as the port's other command lines
take it; `--gpu` is accepted and unused (partitioning reads no device).
"""
from ..utils.cli import ArgumentParser
from .core import datasets


def main():
    parser = ArgumentParser(description='Partition datasets')
    parser.add_argument(
        '--datasets', nargs='+',
        help='The datasets to partition (default: config.DATASETS)')
    args = parser.parse_args()
    datasets(args.datasets, args.config)


if __name__ == '__main__':
    main()
