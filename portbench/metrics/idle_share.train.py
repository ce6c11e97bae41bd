"""idle_share.train: 1 - (union of the device events' intervals) /
window, of the traced training window, as a percentage"""


def read(reading):
    return 100. * (1. - reading.trace.busy_s() / reading.trace.window_s)
