"""The device events launched inside the program's spans of one name

A device event belongs to a span when the host call that launched it
lies inside the span's interval (`program_spans`: the program's spans on
the profiler's clock). Spans of one name do not nest. Used by the
readers of the zero-shot speaker stage (`metrics/*.speaker.py`).
"""
import bisect

from . import program_spans


def spans(reading, name):
    """The window's closed spans `name`, in order; None where the
    program keeps no spans or recorded none of them"""
    records = program_spans.records()
    if records is None:
        return None
    chosen = sorted(
        (span for span in program_spans.in_window(
            records, reading.trace.window_ns) if span.name == name),
        key=lambda span: span.start_ns)
    return chosen or None


def events(reading, chosen):
    """[(start_ns, end_ns, name)] of the device events (kernels and
    copies) launched inside one of the spans `chosen`"""
    starts = [span.start_ns for span in chosen]
    out = []
    for start, end, launch, name in reading.trace.kernels:
        index = bisect.bisect_right(starts, launch) - 1
        if index >= 0 and chosen[index].start_ns <= launch <= \
                chosen[index].end_ns:
            out.append((start, end, name))
    return out


def is_copy(name):
    """A copy or a fill, not a kernel (as `trace.Trace.launches` counts)"""
    return name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset'))
