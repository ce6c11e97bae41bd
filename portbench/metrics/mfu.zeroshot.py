"""mfu.zeroshot: the least time of the window's model work over the
window, as a percentage, for zero-shot requests: what `mfu.infer`
counts (each request's pitch CNN and PPG side, each vocoder call, by
`portbench.counts`), plus each request's WavLM x-vector at its true
16 kHz samples (`peak_share.speaker`'s `flops`) at the bf16 peak"""
import importlib.util
from pathlib import Path

from portbench import counts


def _wavlm_flops():
    path = Path(__file__).with_name('peak_share.speaker.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_peak_share_speaker_counts', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.flops


def read(reading):
    peak, work = reading.peak, reading.window.work
    vocoder = getattr(counts, reading.config_file.get('vocoder_flops', ''),
                      None)
    if peak is None or vocoder is None or 'wavlm' not in reading.config_file:
        return None
    least = sum(counts.preprocess_least_seconds(frames, peak)
                for frames in work.get('preprocess_frames', ()))
    least += sum(vocoder(frames, reading.config) / peak['bfloat16']
                 for rows in work['generator_calls'] for frames in rows)
    flops = _wavlm_flops()
    least += sum(flops(samples, reading.config_file['wavlm'])
                 for samples in work.get('speaker_samples', ())) / \
        peak['bfloat16']
    return 100. * least / reading.trace.window_s
