# bucket_frames first: the modules below import the preprocessing, which
# imports it from here
from .collate import bucket_frames, collate
from . import (
    augment, dataset, download, native, pack, preprocess, resident,
    synthetic)
from .dataset import Dataset
from .loader import Loader, loader
from .sampler import Sampler
