"""idle_ms.synthesize: device idle time a request inside the program's
`synthesize` spans outside the `vocoder` spans: padding, the features,
the speaker, the output's copy to the host (`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('synthesize',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.synthesize')
