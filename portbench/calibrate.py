"""Readings for the limits of a cell: the program over many seeds and
the control over a few, in one process

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--fault half|unchanged] \
        [--out <file.jsonl>]

Each seed is one run of the cell as `run.py` makes it (set-up, a window
of `--seconds`, the comparison); the control puts the reference in
scaled float8 in the program's place. `--fault` plants a fault in the
port's training step for the program's runs (`planted`). Every run
prints one JSON line:
the system, the seed, each number compared and the end-to-end metrics.
The benchmark's own runs never run this; the limits in
`limits/<cell>.json` are set from its readings (PERF.md gives them).
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def planted(fault):
    """The port's training step with `fault`: 'half' leaves half of each
    batch out and takes the mean over the rest; 'unchanged' returns the
    state as it found it"""
    import torch
    from promonet_tpu_torch.train import core
    step = core.train_step

    def faulty(state, batch, *args, **kwargs):
        if fault == 'half':
            rows = batch['audio'].shape[0] // 2
            return step(state, {name: value[:rows] for name, value in
                                batch.items()}, *args, **kwargs)
        saved = {name: value.detach().clone()
                 for name, value in state.trainable.items()}
        metrics = step(state, batch, *args, **kwargs)
        with torch.no_grad():
            for name, value in saved.items():
                state.trainable[name].copy_(value)
        return metrics

    core.train_step = faulty if fault else step
    try:
        yield
    finally:
        core.train_step = step


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--seeds', type=int, nargs='*', default=[])
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--fault', choices=('half', 'unchanged'))
    parser.add_argument('--out')
    arguments = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_benchmark(ROOT), arguments.workload, ROOT)
    # Readings are taken before any limit is set
    cell.limits = None
    out = open(arguments.out, 'a') if arguments.out else None
    runs = [('program', seed) for seed in arguments.seeds] + [
        ('control', seed) for seed in arguments.control_seeds]
    for system, seed in runs:
        start = time.perf_counter()
        with planted(arguments.fault if system == 'program' else None):
            result, checks = harness.run_cell(
                cell, seed, arguments.seconds, 0, start,
                torch.device('cuda'), system)
        line = json.dumps({
            'workload': cell.name, 'system': system, 'seed': seed,
            'fault': arguments.fault if system == 'program' else None,
            'numbers': {check.name: check.value for check in checks},
            'metrics': {name: metric['value']
                        for name, metric in result['metrics'].items()},
            'attempted': result['attempted'], 'failed': result['failed'],
            'seconds': time.perf_counter() - start})
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
