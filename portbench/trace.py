"""Spans, ranges and the device trace of a traced run

With tracing off every call here is free: no range is opened and no
synchronize is made, so the timed run measures the program alone.
With tracing on, the window runs under `torch.profiler` (CPU and CUDA
activities); `range(name)` opens a host range `portbench.<name>` around
work, and `span(name)` does the same with a `synchronize` at each end
and keeps the host time between them. `reduce` turns the profiler's
events into a `Trace`: the device events of the window, the union of
their intervals (busy time), and for each range the device time of the
kernels launched inside it, a kernel being in a range when the host
call that launched it lies inside the range's interval. No kernel is
picked by its name.
"""
import bisect
import collections
import contextlib
import time

import torch

PREFIX = 'portbench.'


class Tracer:
    def __init__(self, on):
        self.on = bool(on)
        self.spans = collections.defaultdict(list)
        self.profile = None

    @contextlib.contextmanager
    def range(self, name):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    @contextlib.contextmanager
    def span(self, name):
        if not self.on:
            yield
            return
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
            torch.cuda.synchronize()
        self.spans[name].append(time.perf_counter() - start)

    @contextlib.contextmanager
    def window(self):
        """The measured window, under the profiler when tracing"""
        if not self.on:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as profile:
            with torch.profiler.record_function(PREFIX + 'window'):
                yield
            torch.cuda.synchronize()
        self.profile = profile


class Trace:
    """The reduced device trace of a window

    kernels: [(start_ns, end_ns, launch_ns, name)] of the device events
        that started inside the window, kernels and copies alike
    ranges: {range name: [(start_ns, end_ns)]} on the host
    window_ns: (start, end) of the window range
    """

    def __init__(self, kernels, ranges, window_ns):
        self.kernels = kernels
        self.ranges = ranges
        self.window_ns = window_ns

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def launches(self):
        """Device kernels (not copies or fills) in the window"""
        return sum(1 for kernel in self.kernels if not _is_copy(kernel[3]))

    def busy_s(self):
        """Seconds in which some device event ran: the union of their
        intervals, cut to the window"""
        start_w, end_w = self.window_ns
        intervals = sorted(
            (max(start, start_w), min(end, end_w))
            for start, end, _, _ in self.kernels)
        busy, current_start, current_end = 0, None, None
        for start, end in intervals:
            if end <= start:
                continue
            if current_end is None or start > current_end:
                if current_end is not None:
                    busy += current_end - current_start
                current_start, current_end = start, end
            else:
                current_end = max(current_end, end)
        if current_end is not None:
            busy += current_end - current_start
        return busy / 1e9

    def device_seconds(self, name):
        """Device time of the events launched inside range `name`; None
        where the range caught none"""
        intervals = sorted(self.ranges.get(name, ()))
        if not intervals:
            return None
        starts = [start for start, _ in intervals]
        total, caught = 0, 0
        for start, end, launch, _ in self.kernels:
            index = bisect.bisect_right(starts, launch) - 1
            if index >= 0 and intervals[index][0] <= launch <= \
                    intervals[index][1]:
                total += end - start
                caught += 1
        return total / 1e9 if caught else None

    def top_device_ops(self, count=10):
        by_name = collections.Counter()
        for start, end, _, name in self.kernels:
            by_name[name[:120]] += (end - start) / 1e9
        return [[name, seconds] for name, seconds in by_name.most_common(
            count)]

    def idle_gaps(self, count=10):
        """Idle device time inside the window, summed by what the host
        was doing when each gap began: the innermost benchmark range then
        open, else 'harness'"""
        start_w, end_w = self.window_ns
        spans = sorted(
            (start, end, name) for name, intervals in self.ranges.items()
            if name != 'window' for start, end in intervals)
        starts = [start for start, _, _ in spans]
        gaps = collections.Counter()
        previous_end = start_w
        for start, end, _, _ in sorted(self.kernels) + [(end_w, end_w, 0, '')]:
            if start > previous_end:
                gaps[_host_at(spans, starts, previous_end)] += (
                    start - previous_end) / 1e9
            previous_end = max(previous_end, end)
        return [[name, seconds] for name, seconds in gaps.most_common(count)]


def _host_at(spans, starts, moment):
    """Innermost range open at `moment`: the latest started that covers
    it; 'harness' where none does"""
    for index in range(bisect.bisect_right(starts, moment) - 1, -1, -1):
        if spans[index][1] >= moment:
            return spans[index][2]
    return 'harness'


def _is_copy(name):
    return name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset'))


def reduce(profile):
    """A `Trace` of a finished `torch.profiler.profile`"""
    events = profile.profiler.kineto_results.events()
    launches, device, ranges = {}, [], collections.defaultdict(list)
    for event in events:
        if event.device_type() == torch.autograd.DeviceType.CPU:
            name = event.name()
            if name.startswith(PREFIX):
                ranges[name[len(PREFIX):]].append(
                    (event.start_ns(), event.end_ns()))
            elif event.correlation_id():
                launches[event.correlation_id()] = event.start_ns()
        elif not event.is_user_annotation() and \
                not event.name().startswith(PREFIX):
            device.append(event)
    window = ranges.get('window')
    if not window:
        raise RuntimeError('the traced window recorded no window range')
    window_ns = window[0]
    kernels = []
    for event in device:
        start = event.start_ns()
        if not window_ns[0] <= start <= window_ns[1]:
            continue
        link = event.linked_correlation_id() or event.correlation_id()
        kernels.append((start, event.end_ns(), launches.get(link, -1),
                        event.name()))
    return Trace(kernels, dict(ranges), window_ns)
