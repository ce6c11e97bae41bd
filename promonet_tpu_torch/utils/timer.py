"""Named wall-clock timing with real-time factors, and the program's spans

Counterpart of `promonet_tpu/utils/timer.py`. The JAX module keeps its
totals in module globals; here they belong to a `Timer` that its caller
creates (the evaluation makes one per run). PyTorch returns before the
card finishes, so on a CUDA device a phase starts and ends with
`torch.cuda.synchronize(device)`: each phase's wall time is then the
card's work inside it, not the time to queue that work. `profile` traces
a region for the profiler's viewers.

`span(name, **counts)` marks a stage of the program: the entry points,
their stages and the kernels' calls each open one (the names are listed
in the README). A span records only while a `torch.profiler` session
runs (`profile`, or any `torch.profiler.profile` of the caller): it then
keeps a `Record` in memory, read with `spans()` and dropped with
`reset()` (or by `profile` as it starts; the newest `KEPT` are kept),
and opens `record_function('promonet.<name>')`, so the span
shows on the profiler's timeline. Outside a session a span reads one
flag and does nothing else. A span never synchronizes and reads no
device value: its start and end are the host's, on `time.time_ns()`'s
clock, which is the clock of the profiler's events, and its counts come
from shapes, lengths and host counters the caller knows. Entered, a
span gives its record's counts, which the caller may set before it
closes (None outside a session).
"""
import collections
import contextlib
import itertools
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as autograd_profiler


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
    read. The spans kept before are dropped (`reset`), so `spans()`
    afterwards gives the region's"""
    reset()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(directory))):
        yield


class Record:
    """One span: `name`, `id`, `parent` (the id of the span open around
    it on the same thread, 0 for none), `start_ns` and `end_ns` (host
    time, `time.time_ns()`; `end_ns` None while the span is open) and the
    `counts` its caller gave"""
    __slots__ = ('name', 'id', 'parent', 'start_ns', 'end_ns', 'counts')

    def __init__(self, name, id, parent, start_ns, counts):
        self.name, self.id, self.parent = name, id, parent
        self.start_ns, self.end_ns, self.counts = start_ns, None, counts

    def __repr__(self):
        return (f'Record({self.name!r}, id={self.id}, parent={self.parent}, '
                f'start_ns={self.start_ns}, end_ns={self.end_ns}, '
                f'counts={self.counts})')


# The most records kept: a process profiled now and then, and never
# reset, keeps the newest
KEPT = 2 ** 18
_records = collections.deque(maxlen=KEPT)
_ids = itertools.count(1)
_open = threading.local()


class _Off:
    """The span of a call made outside a profiler session"""
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exception):
        return False


_OFF = _Off()


class _On:
    """The span of a call made inside a profiler session"""
    __slots__ = ('name', 'counts', 'record', 'range')

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_open, 'stack', None)
        if stack is None:
            stack = _open.stack = []
        self.record = Record(
            self.name, next(_ids), stack[-1].id if stack else 0,
            time.time_ns(), self.counts)
        stack.append(self.record)
        _records.append(self.record)
        self.range = autograd_profiler.record_function(
            'promonet.' + self.name)
        self.range.__enter__()
        return self.record.counts

    def __exit__(self, *exception):
        try:
            self.range.__exit__(*exception)
        finally:
            self.record.end_ns = time.time_ns()
            _open.stack.pop()
        return False


def span(name, **counts):
    """A context manager that marks the stage `name` of the program

    Inside a profiler session it keeps a `Record` of the stage with
    `counts` (numbers from shapes, lengths and host counters), opens the
    profiler range `promonet.<name>` and, entered, gives the record's
    counts, which the caller may set before the span closes; outside one
    it does nothing and gives None."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, counts)


def spans():
    """The records of the spans kept since the last `reset`, in the order
    they opened"""
    return list(_records)


def reset():
    """Drop the kept records"""
    _records.clear()
