"""fused_share.fargan: the share of FARGAN's subframes that ran as one
launch of kernel K4: 100 x the sum of `fused` over the sum of `subframes`
(rows x subframes) of the program's `frame_loop` spans in the window, in
%. None where the program records no such span (before K4)"""
from portbench import program_spans


def read(reading):
    spans = program_spans.records()
    if spans is None:
        return None
    chosen = [span for span in program_spans.in_window(
        spans, reading.trace.window_ns) if span.name == 'frame_loop']
    subframes = sum(span.counts.get('subframes', 0) for span in chosen)
    if not subframes:
        return None
    return 100. * sum(
        span.counts.get('fused', 0) for span in chosen) / subframes
