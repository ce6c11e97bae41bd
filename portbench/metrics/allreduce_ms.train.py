"""allreduce_ms.train: device time of the NCCL kernels of the traced
window (the kernels whose name carries `nccl`: the gradients'
all-reduces) per training step on rank 0, in ms. None where none ran"""


def read(reading):
    steps = reading.window.work.get('steps')
    seconds = sum((end - start) / 1e9 for start, end, _, name
                  in reading.trace.kernels if 'nccl' in name.lower())
    if not steps or not seconds:
        return None
    return 1e3 * seconds / steps
