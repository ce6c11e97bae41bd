"""idle_ms.pitch: device idle time a request inside the program's
`preprocess.pitch` spans (the pitch CNN, its posteriorgram and the
refinement) and the `viterbi.decode` spans (K2) within them
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('preprocess.pitch', 'viterbi.decode')


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.pitch')
