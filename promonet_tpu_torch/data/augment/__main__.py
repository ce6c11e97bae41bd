"""python -m promonet_tpu_torch.data.augment"""
from promonet_tpu_torch.data.augment import datasets
from promonet_tpu_torch.utils.cli import ArgumentParser


def main():
    parser = ArgumentParser(description='Augment datasets')
    parser.add_argument(
        '--datasets', nargs='+', help='The datasets to augment')
    args = parser.parse_args()
    datasets(args.datasets, config=args.config)


if __name__ == '__main__':
    main()
