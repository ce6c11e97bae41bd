"""Linear spectrograms and log-mels (counterpart of `preprocess/spectrogram.py`)"""
from ..ops import mel as mel_ops, stft as stft_ops


def from_audio(audio, config):
    """Magnitude spectrogram of audio (..., 1, T): (..., n_freq, frames)

    The magnitude is sqrt(|S|^2 + 1e-6), as in the JAX package.
    """
    audio = stft_ops.reflect_pad(audio, (config.NUM_FFT - config.HOPSIZE) // 2)
    window = stft_ops.hann_window(config.NUM_FFT, device=audio.device)
    return stft_ops.stft(
        audio[..., 0, :], config.NUM_FFT, config.HOPSIZE, window=window,
        magnitude=True, magnitude_epsilon=1e-6)


def linear_to_mel(spectrogram, config):
    """Linear spectrogram (..., n_freq, T) to log-mels (..., NUM_MELS, T)"""
    return mel_ops.linear_to_mel(
        spectrogram,
        config.SAMPLE_RATE,
        config.NUM_FFT,
        config.NUM_MELS,
        config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD)
