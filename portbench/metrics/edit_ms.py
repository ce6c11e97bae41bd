"""edit_ms: host time a request inside the program's `edit` spans
(`edit.from_features`), in ms"""
from portbench import program_spans


def read(reading):
    return program_spans.wall_ms(reading, 'edit')
