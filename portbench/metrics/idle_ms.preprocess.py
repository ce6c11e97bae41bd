"""idle_ms.preprocess: device idle time a request inside the program's
`preprocess` spans outside their stage spans: resampling, padding, the
copy of the audio to the device, the trims (`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('preprocess',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.preprocess')
