from . import stream
from .core import (
    from_edited_audio, from_features, from_features_batched, from_file,
    from_file_to_file, from_files_to_files, generate)
from .stream import FARGANStreamer, Streamer
