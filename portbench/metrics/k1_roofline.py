"""k1_roofline: least time of the HiFi-GAN Blocks' work at the requests'
true lengths over the device time of every kernel launched inside a
Block call (the `k1` ranges), as a percentage"""
from portbench import counts


def read(reading):
    measured = reading.trace.device_seconds('k1')
    if not measured or reading.peak is None:
        return None
    least = sum(
        counts.k1_least_seconds(rows, reading.config, reading.peak)
        for rows in reading.window.work['generator_calls'])
    return 100. * least / measured
