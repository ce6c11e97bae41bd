"""Resampling (counterpart of `promonet_tpu/utils/audio.py::resample`)

Host-side scipy, as in the JAX package, so both give the same samples.
"""
import numpy as np
import scipy.signal


def resample(audio, sample_rate, target_sample_rate):
    """Polyphase resampling of (..., T) numpy audio, float32

    Rate pairs whose reduced ratio exceeds 512 would need polyphase
    filters of 10^5 and more taps; those go through FFT resampling.
    """
    if sample_rate == target_sample_rate:
        return audio
    gcd = np.gcd(int(sample_rate), int(target_sample_rate))
    up = int(target_sample_rate) // gcd
    down = int(sample_rate) // gcd
    if max(up, down) > 512:
        num = int(round(audio.shape[-1] * target_sample_rate / sample_rate))
        return scipy.signal.resample(audio, num, axis=-1).astype(np.float32)
    return scipy.signal.resample_poly(audio, up, down, axis=-1).astype(
        np.float32)
