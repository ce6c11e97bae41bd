"""idle_ms.generator: device idle time a step inside the program's
`train.generator` spans: the generator's forward pass (`program_spans`),
in ms"""
from portbench import program_spans

SPANS = ('train.generator',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.generator')
