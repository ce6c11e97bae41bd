"""mfu.train: the least time of the window's training steps at the bf16
peak (`counts.train_step_flops`: the generator's and discriminators'
convolutions, forward and backward) over the window, as a percentage"""
from portbench import counts


def read(reading):
    work, peak = reading.window.work, reading.peak
    if peak is None or not work.get('steps'):
        return None
    least = work['steps'] * counts.train_step_flops(
        work['rows'], work['samples'], reading.config) / peak['bfloat16']
    return 100. * least / reading.trace.window_s
