"""python -m promonet_tpu_torch.data.preprocess

Preprocess every cached wav of datasets (`data.preprocess.datasets`), as
`python -m promonet_tpu.data.preprocess` does. `--gpu N` runs on
cuda:N, `--gpu -1` on the CPU, and without it on the default CUDA
device, as the port's other command lines; the pitch CNN and the PPG
encoder come from config.CHECKPOINTS_DIR (`load`).
"""
from ...utils.cli import ArgumentParser
from .core import FEATURES, datasets


def main():
    parser = ArgumentParser(description='Preprocess datasets')
    parser.add_argument(
        '--datasets', nargs='+',
        help='The datasets to preprocess (default: config.DATASETS)')
    parser.add_argument(
        '--features', nargs='+', default=list(FEATURES),
        help='The features to preprocess')
    args = parser.parse_args()
    datasets(
        args.datasets, tuple(args.features), config=args.config,
        device=args.device)


if __name__ == '__main__':
    main()
