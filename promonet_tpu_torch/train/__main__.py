"""python -m promonet_tpu_torch.train

Counterpart of `python -m promonet_tpu.train`, with its arguments:

    python -m promonet_tpu_torch.train [--dataset synthetic] \
        [--train_partition train] [--valid_partition valid] \
        [--adapt_from generator.pt] [--config ...] [--gpu N]

The run goes to config.RUNS_DIR / config.CONFIG (the port's `runs_torch/`
by default), with a copy of each configuration file; a run that has
checkpoints resumes from its newest. `--gpu -1` trains on the CPU.
"""
import shutil
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import train


def main():
    parser = ArgumentParser(description='Train a model')
    parser.add_argument(
        '--dataset', help='The dataset to train on (default: the '
                          'configuration\'s TRAINING_DATASET)')
    parser.add_argument(
        '--train_partition', default='train',
        help='The partition to train on')
    parser.add_argument(
        '--valid_partition', default='valid',
        help='The partition to validate on')
    parser.add_argument(
        '--adapt_from', type=Path,
        help='A generator checkpoint to perform adaptation from')
    args = parser.parse_args()

    directory = args.config.RUNS_DIR / args.config.CONFIG
    directory.mkdir(parents=True, exist_ok=True)
    for config in parser.config_paths:
        target = directory / Path(config).name
        if Path(config).resolve() != target.resolve():
            shutil.copyfile(config, target)

    train(
        directory, args.dataset, args.train_partition, args.valid_partition,
        args.adapt_from, config=args.config, device=args.device)


if __name__ == '__main__':
    main()
