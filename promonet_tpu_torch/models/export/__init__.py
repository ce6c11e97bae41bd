from .core import (
    PackedInference, from_file_to_file, labels, pack_features,
    packed_inference, unpack_features)
