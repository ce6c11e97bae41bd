"""idle_ms.ppg: device idle time a request inside the program's
`preprocess.ppg` spans: the spectrogram, the mels and the PPG encoder
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('preprocess.ppg',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.ppg')
