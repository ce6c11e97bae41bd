"""Unit conversions (counterpart of `promonet_tpu/convert.py`)"""
import math


def cents_to_ratio(cents):
    """Convert pitch ratio in cents to linear ratio"""
    return 2 ** (cents / 1200)


def ratio_to_cents(ratio):
    """Convert linear pitch ratio to cents"""
    return 1200 * math.log2(ratio)


def ratio_to_db(ratio):
    """Convert perceptual loudness ratio to decibels"""
    return 10 * math.log2(ratio)
