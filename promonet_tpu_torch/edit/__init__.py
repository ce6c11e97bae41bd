from . import grid
from .core import from_features, from_file, from_file_to_file, from_files_to_files
