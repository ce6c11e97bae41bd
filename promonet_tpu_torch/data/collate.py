"""Length bucketing and batch collation (counterpart of
`promonet_tpu/data/collate.py`)"""
import numpy as np

from .. import config as config_module


def bucket_frames(frames, buckets):
    """Smallest bucket of the ladder `buckets` that fits `frames`

    Inputs longer than the largest bucket keep their own length.
    """
    for bucket in buckets:
        if frames <= bucket:
            return bucket
    return frames


def collate(items, pad_to_bucket=True, config=None):
    """Items of `data.Dataset` as one batch dict of numpy arrays

    Items are sorted by length, longest first; features are zero-padded
    to the longest item's frames (with `pad_to_bucket`, to its bucket of
    config.INFERENCE_FRAME_BUCKETS), audio to as many samples. 'text' and
    'stems' are lists, 'lengths' the frames of each item.
    """
    config = config_module.default() if config is None else config
    items = sorted(
        items, key=lambda item: item['pitch'].shape[-1], reverse=True)
    max_frames = items[0]['pitch'].shape[-1]
    if pad_to_bucket:
        max_frames = bucket_frames(
            max_frames, config.INFERENCE_FRAME_BUCKETS)
    max_samples = max_frames * config.HOPSIZE

    def pad(x, target):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])

    batch = {
        'text': [item['text'] for item in items],
        'stems': [item['stems'] for item in items],
        'lengths': np.asarray(
            [item['pitch'].shape[-1] for item in items], np.int32)}
    for key in ('loudness', 'ppg', 'spectrograms', 'pitch', 'periodicity'):
        batch[key] = np.stack([pad(item[key], max_frames) for item in items])
    batch['audio'] = np.stack(
        [pad(item['audio'][..., :max_samples], max_samples)
         for item in items])
    batch['speakers'] = np.stack([item['speakers'] for item in items])
    for key in ('spectral_balance_ratios', 'loudness_ratios'):
        batch[key] = np.stack([item[key] for item in items])
    return batch
