"""Linear spectrograms and log-mels (counterpart of `preprocess/spectrogram.py`)"""
import torch

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..ops import mel as mel_ops, stft as stft_ops


def from_audio(
    audio,
    config,
    mels=False,
    log_dynamic_range_compression_threshold='default'
):
    """Magnitude spectrogram of audio (..., 1, T): (..., n_freq, frames),
    or with `mels` its log-mels (..., NUM_MELS, frames)

    The magnitude is sqrt(|S|^2 + 1e-6), as in the JAX package. The
    threshold floors the log-mels; 'default' takes config's
    LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD, None none.
    """
    audio = stft_ops.reflect_pad(audio, (config.NUM_FFT - config.HOPSIZE) // 2)
    window = stft_ops.hann_window(config.NUM_FFT, device=audio.device)
    spectrogram = stft_ops.stft(
        audio[..., 0, :], config.NUM_FFT, config.HOPSIZE, window=window,
        magnitude=True, magnitude_epsilon=1e-6)
    if mels:
        return linear_to_mel(
            spectrogram, config, log_dynamic_range_compression_threshold)
    return spectrogram


def from_file(audio_file, mels=False, config=None, device='cuda'):
    """(Mel) spectrogram of a wav file, (n_freq or NUM_MELS, frames)"""
    config = config_module.default() if config is None else config
    audio = torch.from_numpy(load.audio(audio_file, config)).to(
        device_module.resolve(device))
    return from_audio(audio, config, mels)


def from_file_to_file(audio_file, output_file, mels=False, config=None,
                      device='cuda'):
    """(Mel) spectrogram of a wav file, saved to `output_file`"""
    load.save_array(output_file, from_file(audio_file, mels, config, device))


def from_files_to_files(audio_files, output_files, mels=False, config=None,
                        device='cuda'):
    """(Mel) spectrograms of several wav files, in turn"""
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, mels, config, device)


def linear_to_mel(
    spectrogram,
    config,
    log_dynamic_range_compression_threshold='default'
):
    """Linear spectrogram (..., n_freq, T) to log-mels (..., NUM_MELS, T)

    The threshold as `from_audio` takes it.
    """
    if log_dynamic_range_compression_threshold == 'default':
        log_dynamic_range_compression_threshold = \
            config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD
    return mel_ops.linear_to_mel(
        spectrogram,
        config.SAMPLE_RATE,
        config.NUM_FFT,
        config.NUM_MELS,
        log_dynamic_range_compression_threshold)
