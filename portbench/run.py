"""Run one cell of the benchmark once and print its result line

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository, on a host with an
NVIDIA GPU. Set-up (imports included) is timed from the start of this
file. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, then `checks`); the numbers compared, each beside its
limit, are also the last lines of standard error. Without a card, with
fewer cards than the cell asks for, or with JAX loaded at the end, it
prints no result and exits with a non-zero code.
"""
import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Every build and kernel cache inside the checkout, at fixed paths
for variable, directory in (
    ('TORCH_EXTENSIONS_DIR', 'build/torch_extensions'),
    ('TRITON_CACHE_DIR', 'build/triton'),
    ('CUDA_CACHE_PATH', 'build/nv_cache'),
):
    os.environ[variable] = str(ROOT / directory)
os.environ['USE_FLAX'] = '0'

if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], START, ROOT))
