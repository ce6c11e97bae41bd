"""idle_ms.step: device idle time a step inside the program's
`train.step` spans outside its five phase spans: chiefly the release of
the step's autograd graph and activations as the step returns
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('train.step',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.step')
