"""python -m promonet_tpu_torch.train

Counterpart of `python -m promonet_tpu.train`, with its arguments:

    python -m promonet_tpu_torch.train [--dataset synthetic] \
        [--train_partition train] [--valid_partition valid] \
        [--adapt_from generator.pt] [--config ...] [--gpu N]

The run goes to config.RUNS_DIR / config.CONFIG (the port's `runs_torch/`
by default), with a copy of each configuration file; a run that has
checkpoints resumes from its newest. `--gpu -1` trains on the CPU.

Data-parallel over N cards of one host:

    torchrun --nproc_per_node N -m promonet_tpu_torch.train [...]

Where WORLD_SIZE (set by torchrun) is above 1, each process joins the
process group (NCCL on cards, gloo with `--gpu -1`), trains on
cuda:LOCAL_RANK, and leaves the group at the end; BATCH_SIZE is the
global batch, split over the ranks.
"""
import datetime
import os
import shutil
from pathlib import Path

from ..utils.cli import ArgumentParser
from .core import train

# How long a rank waits at a collective: rank 0 validates, checkpoints and
# pauses (`utils.pause`) while the others wait for it
TIMEOUT = datetime.timedelta(hours=2)


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

    device = args.device
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world > 1:
        import torch
        import torch.distributed as dist
        if device == 'cpu':
            dist.init_process_group('gloo', timeout=TIMEOUT)
        else:
            device = f'cuda:{int(os.environ["LOCAL_RANK"])}'
            torch.cuda.set_device(device)
            dist.init_process_group('nccl', timeout=TIMEOUT)
    try:
        directory = args.config.RUNS_DIR / args.config.CONFIG
        if int(os.environ.get('RANK', '0')) == 0:
            directory.mkdir(parents=True, exist_ok=True)
            for config in parser.config_paths:
                target = directory / Path(config).name
                if Path(config).resolve() != target.resolve():
                    shutil.copyfile(config, target)
        train(
            directory, args.dataset, args.train_partition,
            args.valid_partition, args.adapt_from, config=args.config,
            device=device)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
