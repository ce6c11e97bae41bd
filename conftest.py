"""The CPU threads of every test process, set in one place.

pytest loads this file in each process it runs tests in, the xdist
workers included, before `tests/conftest.py` and before a test module
imports torch. The tier-1 run has six workers on an eight-core host. There
PyTorch's default of one intra-op thread per core oversubscribes the cores,
and the many small operations of a parity test wait on each other: a file
that takes seconds alone takes minutes.

The count goes into the environment too, so that the processes a test
starts (the CLIs, the gloo ranks) run at the same count: some comparisons
between such a process and the test's own are exact only at one count.
Three is the least count at which every test holds: at one or two the
port's float32 FARGAN sums in another order, and its first frames leave
the JAX package's streaming contract (`test_torch_vocoders.py`).
"""
import os

THREADS = 3

os.environ['OMP_NUM_THREADS'] = os.environ['MKL_NUM_THREADS'] = str(THREADS)

import torch  # noqa: E402

# For where torch was imported before this file was
torch.set_num_threads(THREADS)
