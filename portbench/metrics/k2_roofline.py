"""k2_roofline: least time of the Viterbi decodes at the requests' true
lengths over the device time of every kernel launched inside a call of
`ops.viterbi.decode` (the `k2` ranges), as a percentage"""
from portbench import counts


def read(reading):
    measured = reading.trace.device_seconds('k2')
    if not measured or reading.peak is None:
        return None
    least = sum(counts.k2_least_seconds(frames, reading.peak)
                for frames in reading.window.work['preprocess_frames'])
    return 100. * least / measured
