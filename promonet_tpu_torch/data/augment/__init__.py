from .core import datasets, from_files_to_files, loudness_shift, pitch_shift, \
    sample
