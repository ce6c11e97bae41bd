"""Length bucketing (counterpart of `promonet_tpu/data/collate.py`)"""


def bucket_frames(frames, buckets):
    """Smallest bucket of the ladder `buckets` that fits `frames`

    Inputs longer than the largest bucket keep their own length.
    """
    for bucket in buckets:
        if frames <= bucket:
            return bucket
    return frames
