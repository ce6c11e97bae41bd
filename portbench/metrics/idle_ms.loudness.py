"""idle_ms.loudness: device idle time a request inside the program's
`preprocess.loudness` spans (`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('preprocess.loudness',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.loudness')
