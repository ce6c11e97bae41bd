"""Audio file IO and resampling (counterpart of
`promonet_tpu/utils/audio.py`)

Host-side scipy, as in the JAX package, so both give the same samples.
Audio is float32 numpy in the (channels, time) layout. scipy.signal is
imported where it is used: its import takes seconds, which every
command-line entry point would otherwise wait for.
"""
import wave

import numpy as np
from scipy.io import wavfile


def load(file, target_sample_rate=None):
    """A wav file as float32 (1, T), mono, maybe resampled

    Integer PCM is scaled to [-1, 1] (int16 by 1 / 32768, int32 by
    1 / 2^31, uint8 centred on 128); several channels are averaged.

    Returns
        audio (1, T), sample rate
    """
    sample_rate, data = wavfile.read(file)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.) / 128.
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if target_sample_rate is not None and sample_rate != target_sample_rate:
        data = resample(data, sample_rate, target_sample_rate)
        sample_rate = target_sample_rate
    return data[None], sample_rate


def save(file, audio, sample_rate):
    """Save float audio (T,) or (1, T) as a 16-bit PCM wav file

    Samples are clipped to [-1, 1] and scaled by 32767, truncating.
    """
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio[0]
    audio = np.clip(audio, -1., 1.)
    wavfile.write(file, int(sample_rate), (audio * 32767).astype(np.int16))


def duration(file):
    """Length of a wav file in seconds, from its header"""
    with wave.open(str(file), 'rb') as handle:
        return handle.getnframes() / handle.getframerate()


def resample(audio, sample_rate, target_sample_rate):
    """Polyphase resampling of (..., T) numpy audio, float32

    Rate pairs whose reduced ratio exceeds 512 would need polyphase
    filters of 10^5 and more taps; those go through FFT resampling.
    """
    import scipy.signal

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
