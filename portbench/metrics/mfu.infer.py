"""mfu.infer: the least time of the window's model work over the
window, as a percentage. Each request's pitch CNN and PPG side at its
true input frames (`counts.preprocess_least_seconds`) and each vocoder
call at its rows' true output frames, at the bf16 peak, by the count
function that the configuration's file names (`vocoder_flops`); a
configuration that names none leaves the metric out. Convolutions and
matrix products only"""
from portbench import counts


def read(reading):
    peak, work = reading.peak, reading.window.work
    vocoder = getattr(counts, reading.config_file.get('vocoder_flops', ''),
                      None)
    if peak is None or vocoder is None:
        return None
    least = sum(counts.preprocess_least_seconds(frames, peak)
                for frames in work.get('preprocess_frames', ()))
    least += sum(vocoder(frames, reading.config) / peak['bfloat16']
                 for rows in work['generator_calls'] for frames in rows)
    return 100. * least / reading.trace.window_s
