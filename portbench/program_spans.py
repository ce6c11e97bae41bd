"""The program's own spans laid against the device trace of a window

The port records a span at each of its layer boundaries while a profiler
runs (`promonet_tpu_torch.utils.timer.spans()`: name, id, parent, start
and end on `time.time_ns()`'s clock, which is the clock of the
profiler's events, and counts from shapes). Here the window's idle time,
the window less the union of its device events (`Trace.kernels`), is cut
at the spans' edges, and each piece goes to the innermost span open
during it, or to `outside` where none is.

An idle metric's reader declares the span names it reads, `SPANS` in
`metrics/<name>.py`. Its family is every metric of `BENCHMARK.json`'s
`per_layer` list that moves the same end-to-end metric and whose reader
declares `SPANS`. A metric reads the pieces of its spans and of every
span below them that no other metric of its family names, so the metrics
of a family partition the idle time inside the spans they name, and a
span that only another family names (a `vocoder` inside
`train.generator`) counts for its nearest named ancestor. No two
metrics of a family name one span. So a new idle metric of a span
inside another metric's spans takes that span's idle out of the other
metric's reading, and takes the span out of the other's `SPANS` where
it is listed there: an `idle_ms.decode` of `viterbi.decode` would lower
`idle_ms.pitch`, and `viterbi.decode` would leave its `SPANS`.

The benchmark also runs against programs from before the spans, whose
`utils.timer` keeps none: every reader here then returns None.
"""
import collections
import heapq
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

BASE = Path(__file__).resolve().parent
OUTSIDE = 'outside'


def records():
    """The program's span records, or None where the program keeps none"""
    from promonet_tpu_torch.utils import timer
    spans = getattr(timer, 'spans', None)
    return spans() if spans is not None else None


def family(metric, base=BASE):
    """{metric name: its reader's SPANS} of the idle metrics that move
    the end-to-end metric `metric` moves, in `BENCHMARK.json`'s order"""
    entries = json.loads(
        (base.parent / 'BENCHMARK.json').read_text())['per_layer']
    moves = next(entry['moves'] for entry in entries
                 if entry['name'] == metric)
    out = {}
    for entry in entries:
        if entry['moves'] != moves:
            continue
        path = base / 'metrics' / f"{entry['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_spans_{entry['name'].replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if hasattr(module, 'SPANS'):
            out[entry['name']] = tuple(module.SPANS)
    named = [name for spans in out.values() for name in spans]
    twice = {name for name in named if named.count(name) > 1}
    if twice:
        raise ValueError(f'spans named by two metrics of a family: {twice}')
    return out


def in_window(spans, window_ns):
    """The closed spans that overlap the window"""
    start_w, end_w = window_ns
    return [span for span in spans if span.end_ns is not None and
            span.start_ns < end_w and span.end_ns > start_w]


def idle_intervals(trace):
    """The window's idle intervals as two arrays (starts, ends) of
    nanoseconds: the complement of the union of the device events, cut
    to the window"""
    start_w, end_w = trace.window_ns
    events = np.array([(start, end) for start, end, _, _ in trace.kernels],
                      dtype=np.int64).reshape(-1, 2)
    events = np.clip(events, start_w, end_w)
    events = events[events[:, 1] > events[:, 0]]
    events = events[np.argsort(events[:, 0], kind='stable')]
    # Each event's start against the latest end before it
    covered = np.maximum.accumulate(
        np.concatenate([[start_w], events[:, 1]]))
    starts = np.concatenate([covered[:-1], covered[-1:]])
    ends = np.concatenate([events[:, 0], [end_w]])
    idle = ends > starts
    return starts[idle], ends[idle]


def owners(spans, window_ns):
    """The window cut at the spans' edges: [(start_ns, end_ns, owner)],
    in order and covering it, each owner the id of the innermost span
    open there (the latest opened of those open), 0 where none is"""
    start_w, end_w = window_ns
    edges = []
    for span in spans:
        start, end = max(span.start_ns, start_w), min(span.end_ns, end_w)
        if end > start:
            edges.append((start, 1, span))
            edges.append((end, 0, span))
    edges.sort(key=lambda edge: (edge[0], edge[1]))
    segments, heap, closed, previous = [], [], set(), start_w
    for moment, opens, span in edges:
        if moment > previous:
            while heap and heap[0][2] in closed:
                heapq.heappop(heap)
            segments.append((previous, moment, heap[0][2] if heap else 0))
            previous = moment
        if opens:
            heapq.heappush(heap, (-span.start_ns, -span.id, span.id))
        else:
            closed.add(span.id)
    if end_w > previous:
        segments.append((previous, end_w, 0))
    return segments


def idle_by_span(trace, spans):
    """{span id (0: outside any span): idle seconds} of the window"""
    segments = owners(spans, trace.window_ns)
    idle_starts, idle_ends = idle_intervals(trace)
    if not len(idle_starts):
        return {}
    # Idle nanoseconds before each idle interval
    before = np.concatenate([[0], np.cumsum(idle_ends - idle_starts)[:-1]])

    def idle_before(moments):
        """Idle nanoseconds of the window before each moment"""
        index = np.searchsorted(idle_starts, moments, side='right') - 1
        last = np.maximum(index, 0)
        return np.where(index >= 0, before[last] + np.minimum(
            moments, idle_ends[last]) - idle_starts[last], 0)

    edges = np.array([[start, end] for start, end, _ in segments],
                     dtype=np.int64)
    pieces = idle_before(edges[:, 1]) - idle_before(edges[:, 0])
    out = collections.Counter()
    for (_, _, owner), nanoseconds in zip(segments, pieces.tolist()):
        if nanoseconds:
            out[owner] += nanoseconds
    return {owner: nanoseconds / 1e9 for owner, nanoseconds in out.items()}


def by_metric(idle, spans, names):
    """{metric, `outside` or 'unnamed:<root span>': idle seconds}: each
    span's idle to the nearest span at or above it that one of the
    metrics `names` ({metric: its span names}) names"""
    claims = {name: metric for metric, spans_of in names.items()
              for name in spans_of}
    parents = {span.id: span for span in spans}
    out = collections.Counter()
    for owner, seconds in idle.items():
        span = parents.get(owner)
        metric, root = (OUTSIDE if span is None else None), None
        while span is not None:
            metric = claims.get(span.name)
            if metric is not None:
                break
            root, span = span.name, parents.get(span.parent)
        out[metric or f'unnamed:{root}'] += seconds
    return dict(out)


def idle_ms(reading, metric):
    """Idle milliseconds a request or step of `metric`'s spans; None
    where the program recorded none of them. Logs the metric's idle
    seconds and the idle outside every span, which with the window's
    idle (`window_s` less `busy_s`) checks that the family adds up"""
    spans = records()
    count = reading.window.attempted
    if spans is None or not count:
        return None
    names = family(metric)
    spans = in_window(spans, reading.trace.window_ns)
    if not any(span.name in names[metric] for span in spans):
        return None
    idle = by_metric(idle_by_span(reading.trace, spans), spans, names)
    print(f'portbench: program spans: {metric} {idle.get(metric, 0.)!r} s '
          f'idle, {OUTSIDE} {idle.get(OUTSIDE, 0.)!r} s, {count} requests '
          'or steps', file=sys.stderr, flush=True)
    return 1e3 * idle.get(metric, 0.) / count


def wall_ms(reading, name):
    """Host milliseconds a request or step inside the spans `name`; None
    where there are none"""
    spans = records()
    count = reading.window.attempted
    if spans is None or not count:
        return None
    chosen = [span for span in in_window(spans, reading.trace.window_ns)
              if span.name == name]
    if not chosen:
        return None
    return sum(span.end_ns - span.start_ns for span in chosen) / 1e6 / count


def padded_share(reading, name):
    """100 x (1 - sum of `true_frames` / sum of `frames`) over the spans
    `name` in the window; None where there are none"""
    spans = records()
    if spans is None:
        return None
    chosen = [span for span in in_window(spans, reading.trace.window_ns)
              if span.name == name and 'frames' in span.counts]
    frames = sum(span.counts['frames'] for span in chosen)
    if not frames:
        return None
    true = sum(span.counts.get('true_frames', span.counts['frames'])
               for span in chosen)
    return 100. * (1. - true / frames)
