from .collate import bucket_frames
