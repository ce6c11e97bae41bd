"""idle_ms.backward: device idle time a step inside the program's
`train.backward` spans: the generator's gradients and their all-reduce
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('train.backward',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.backward')
