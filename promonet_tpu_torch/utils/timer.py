"""Named wall-clock timing with real-time factors

Counterpart of `promonet_tpu/utils/timer.py`. The JAX module keeps its
totals in module globals; here they belong to a `Timer` that its caller
creates (the evaluation makes one per run). PyTorch returns before the
card finishes, so on a CUDA device a phase starts and ends with
`torch.cuda.synchronize(device)`: each phase's wall time is then the
card's work inside it, not the time to queue that work. `profile` traces
a region for the profiler's viewers.
"""
import contextlib
import time
from collections import defaultdict

import torch


class Timer:
    """Seconds per named phase, summed over the phases of one name

    `device` is the one whose work the phases wait for; a CPU device
    waits for nothing.
    """

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self.totals = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name):
        """Add the wall time of the block to `name`"""
        self._synchronize()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._synchronize()
            self.totals[name] += time.perf_counter() - start

    def results(self):
        """Total seconds per name"""
        return dict(self.totals)

    def rtf(self, num_samples, sample_rate):
        """Real-time factor per name: seconds of audio / wall seconds"""
        audio_seconds = num_samples / sample_rate
        return {
            name: audio_seconds / seconds if seconds > 0 else float('inf')
            for name, seconds in self.results().items()}

    def _synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)


@contextlib.contextmanager
def profile(directory):
    """Trace the enclosed region with torch.profiler: the host's
    operations and, where a card is present, its kernels, written as a
    Chrome/Perfetto trace (`<host>_<pid>.<time>.pt.trace.json`) under
    `directory`, which TensorBoard's profiler plugin and ui.perfetto.dev
    read"""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(directory))):
        yield
