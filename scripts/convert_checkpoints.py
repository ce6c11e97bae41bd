"""Convert the repository's trained checkpoints to the PyTorch port's format.

The trained weights are orbax checkpoints that only the JAX package
restores. This script restores each of them on the CPU with the JAX
package's own loader, carries it over with the port's bridge
(`promonet_tpu_torch.models.bridge`), and writes the port's checkpoint
files (`promonet_tpu_torch.utils.checkpoint`), which torch alone reads:

    python scripts/convert_checkpoints.py [--output checkpoints_torch]

It needs a host with JAX. Into the output directory (by default
`checkpoints_torch/` at the root of the repository, which git ignores) it
writes:
- generator-00155000.pt: the release generator of runs/promonet/release,
  with synthetic.py, the configuration it was trained under (24
  speakers), copied beside it;
- pitch-<step>.pt, ppg-<step>.pt and speaker-<step>.pt: the shipped
  pitch CNN, PPG encoder and speaker encoder, the pitch CNN with its
  calibrated voicing threshold. With no `--output`, the port's loaders
  (`promonet_tpu_torch.load`) find these three on their own.
"""
import argparse
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np  # noqa: E402

from promonet_tpu.utils.checkpoint import load  # noqa: E402
from promonet_tpu_torch.models import bridge  # noqa: E402
from promonet_tpu_torch.utils import checkpoint  # noqa: E402

RELEASE = ROOT / 'runs' / 'promonet' / 'release' / 'generator-00155000'
RELEASE_CONFIG = ROOT / 'runs' / 'promonet' / 'synthetic.py'
SHIPPED = ROOT / 'promonet_tpu' / 'assets' / 'checkpoints'

# (name, orbax checkpoint, converter)
CHECKPOINTS = (
    ('generator', RELEASE, bridge.generator_state_dict),
    ('pitch', SHIPPED / 'pitch', bridge.pitch_state_dict),
    ('ppg', SHIPPED / 'ppg', bridge.ppg_state_dict),
    ('speaker', SHIPPED / 'speaker', bridge.speaker_state_dict))


def convert(output):
    """Write every converted checkpoint to `output`; returns their paths"""
    output = Path(output)
    written = []
    for name, source, state_dict in CHECKPOINTS:
        payload = load(source)
        # Scalars saved beside the weights (step, epoch, the pitch CNN's
        # voicing threshold, training accuracies)
        extra = {
            key: float(value) for key, value in payload.items()
            if key not in ('params', 'opt_state', 'step', 'epoch')
            and np.ndim(value) == 0}
        step = int(payload.get('step', 0))
        path = output / f'{name}-{step:08d}.pt'
        checkpoint.save(
            path, state_dict(payload['params']), step=step,
            epoch=int(payload.get('epoch', 0)), **extra)
        written.append(path)
    shutil.copyfile(RELEASE_CONFIG, output / RELEASE_CONFIG.name)
    written.append(output / RELEASE_CONFIG.name)
    return written


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        '--output', type=Path, default=ROOT / 'checkpoints_torch',
        help='Directory to write the converted checkpoints to')
    for path in convert(parser.parse_args().output):
        print(f'{path} ({path.stat().st_size / 2 ** 20:.1f} MiB)')


if __name__ == '__main__':
    main()
