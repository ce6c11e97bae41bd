"""idle_ms.discriminator: device idle time a step inside the program's
`train.discriminator` spans: the discriminators' forward pass on the
detached output, their loss, gradients and update (`program_spans`), in
ms"""
from portbench import program_spans

SPANS = ('train.discriminator',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.discriminator')
