"""launches.speaker: device kernels (not copies or fills) launched
inside the program's `preprocess.speaker` spans, per span: the WavLM
x-vector's launches a request. None where the program recorded no such
span"""
from portbench import span_kernels


def read(reading):
    chosen = span_kernels.spans(reading, 'preprocess.speaker')
    if chosen is None:
        return None
    return sum(1 for _, _, name in span_kernels.events(reading, chosen)
               if not span_kernels.is_copy(name)) / len(chosen)
