"""launches.infer: device kernels of the traced window per second of
output audio the window delivered"""


def read(reading):
    seconds = reading.window.work.get('output_seconds')
    return reading.trace.launches() / seconds if seconds else None
