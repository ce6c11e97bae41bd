"""launches.train: device kernels of the traced window per training
step"""


def read(reading):
    steps = reading.window.work.get('steps')
    return reading.trace.launches() / steps if steps else None
