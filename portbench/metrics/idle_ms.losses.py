"""idle_ms.losses: device idle time a step inside the program's
`train.losses` spans: the generator's mel, spectral and signal losses,
the second discriminator pass, feature matching and the adversarial loss
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('train.losses',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.losses')
