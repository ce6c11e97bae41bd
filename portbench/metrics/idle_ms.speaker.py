"""idle_ms.speaker: device idle time a request inside the program's
zero-shot speaker spans: the 16 kHz resampling on the host, WavLM's
feature extractor and projection, its encoder and the x-vector head
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('preprocess.speaker', 'speaker.features', 'speaker.encoder',
         'speaker.xvector')


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.speaker')
