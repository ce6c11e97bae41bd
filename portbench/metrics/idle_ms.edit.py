"""idle_ms.edit: device idle time a request inside the program's `edit`
spans (the grid, the resampled features, the shift and the scale)
(`program_spans`), in ms"""
from portbench import program_spans

SPANS = ('edit',)


def read(reading):
    return program_spans.idle_ms(reading, 'idle_ms.edit')
