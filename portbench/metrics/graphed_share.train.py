"""graphed_share.train: the share of the window's training steps that
CUDA graphs ran: 100 x the sum of `graphed` over the number of the
program's `train.step` spans in the window, in %. None where the program
records no such count (before the graphed step)"""
from portbench import program_spans


def read(reading):
    spans = program_spans.records()
    if spans is None:
        return None
    steps = [span for span in program_spans.in_window(
        spans, reading.trace.window_ns) if span.name == 'train.step']
    if not any('graphed' in span.counts for span in steps):
        return None
    return 100. * sum(
        span.counts.get('graphed', 0) for span in steps) / len(steps)
