"""idle_ms.vocoder: device idle time a request inside the program's
`vocoder` spans (the generator's backbone: HiFi-GAN's stages, FARGAN's
conditioning and frame loop) and the `resblock` spans (K1) within them
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('vocoder', 'resblock')


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.vocoder')
