"""idle_ms.optimizer: device idle time a step inside the program's
`train.optimizer` spans: the gradients' extrema, the clip and the
optimizer's step (`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('train.optimizer',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.optimizer')
