"""k4_roofline: least time of the window's K4 launches (FARGAN's subframe
network, the device kernels whose name carries `fargan_subframe`) over
their device time, as a percentage

A launch's least time is the larger of its operations at the bf16 peak
and its bytes at the memory bandwidth. Operations: two a weight a row
(2,246,656 weights). Bytes: the bf16 weights once, and each row's inputs
and outputs: the conditioning slice, pitch lookback, previous subframe
and four states read (bf16), the output and four states written (bf16),
its samples written into the float32 history, and for the next subframe
its lookback's int64 indices and float32 samples read and its lookback
and previous subframe written (bf16). A launch's rows are the `rows`
count of the program's `frame_loop` span it was launched in (one where
none holds it). None where no K4 kernel ran (before K4)."""
import bisect

from portbench import program_spans

SYMBOL = 'fargan_subframe'
HOPSIZE, SUBFRAME = 256, 64


def weights(hopsize=HOPSIZE, subframe=SUBFRAME):
    """The subframe network's weights: fwconv's Dense and GLU, three GRUs
    (input and hidden projections) and their GLUs, the skip Dense and
    GLU, the output Dense"""
    inputs = 4 * subframe + 4
    gru_inputs = hopsize + 2 * subframe
    glu = hopsize * hopsize
    return (hopsize * 2 * inputs + glu +
            3 * (3 * hopsize * gru_inputs + 3 * hopsize * hopsize + glu) +
            hopsize * (4 * hopsize + 2 * subframe) + glu + subframe * hopsize)


def row_bytes(hopsize=HOPSIZE, subframe=SUBFRAME):
    """Bytes a row reads and writes besides the weights"""
    lookback, states = subframe + 4, 3 * hopsize + 4 * subframe + 4
    read = 2 * (2 * subframe + lookback + subframe + states)
    written = 2 * (subframe + states) + 4 * subframe
    following = 8 * lookback + 4 * lookback + 2 * (lookback + subframe)
    return read + written + following


def least_seconds(rows, peak):
    """The least time of one launch over `rows` rows"""
    return max(2. * weights() * rows / peak['bfloat16'],
               (2. * weights() + rows * row_bytes()) / peak['bytes'])


def read(reading):
    launched = [(launch, end - start) for start, end, launch, name
                in reading.trace.kernels if SYMBOL in name]
    if not launched or reading.peak is None:
        return None
    spans = program_spans.records() or []
    loops = sorted(
        (span.start_ns, span.end_ns, span.counts.get('rows', 1))
        for span in program_spans.in_window(spans, reading.trace.window_ns)
        if span.name == 'frame_loop')
    starts = [start for start, _, _ in loops]
    least = 0.
    for launch, _ in launched:
        index = bisect.bisect_right(starts, launch) - 1
        rows = 1
        if index >= 0 and loops[index][0] <= launch <= loops[index][1]:
            rows = loops[index][2]
        least += least_seconds(rows, reading.peak)
    return 100. * least / (sum(seconds for _, seconds in launched) / 1e9)
