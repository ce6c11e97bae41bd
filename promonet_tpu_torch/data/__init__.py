# bucket_frames first: the modules below import the preprocessing, which
# imports it from here
from .collate import bucket_frames
from . import dataset, preprocess, synthetic
from .dataset import Dataset
