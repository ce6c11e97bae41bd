from .core import from_features, from_file_to_file
