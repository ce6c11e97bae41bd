"""Unit conversions (counterpart of `promonet_tpu/convert.py`)"""


def cents_to_ratio(cents):
    """Convert pitch ratio in cents to linear ratio"""
    return 2 ** (cents / 1200)
