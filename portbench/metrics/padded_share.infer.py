"""padded_share.infer: the share of the frames the vocoder ran that were
not real input (bucket padding, rows repeated to fill a batch): 100 x
(1 - true frames / frames) over the program's `vocoder` spans, in %"""
from portbench import program_spans


def read(reading):
    return program_spans.padded_share(reading, 'vocoder')
