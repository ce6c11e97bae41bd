"""idle_share.infer: 1 - (union of the device events' intervals) /
window, of the traced window, as a percentage"""


def read(reading):
    return 100. * (1. - reading.trace.busy_s() / reading.trace.window_s)
