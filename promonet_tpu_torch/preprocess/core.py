"""Feature extraction (counterpart of `promonet_tpu/preprocess/core.py`)

Audio is zero-padded to a bucketed frame count, every feature is
computed on the padded audio, and the results are trimmed to the true
frame count, as the JAX package's fused extractor does. The padding
changes the features of the last frames, so the bucket ladder is part
of the result.
"""
import numpy as np
import torch

from .. import config as config_module
from .. import device as device_module
from ..data import bucket_frames
from . import loudness as loudness_module
from . import pitch as pitch_module
from . import spectrogram as spectrogram_module

FEATURES = ('loudness', 'pitch', 'periodicity', 'ppg')


def from_audio(
    audio,
    pitch_model,
    ppg_model,
    sample_rate=None,
    features=FEATURES,
    loudness_bands='default',
    config=None,
    device='cuda'
):
    """Preprocess audio (1, T) into interpretable features

    Arguments
        audio: (1, T) float waveform at SAMPLE_RATE (numpy or tensor)
        pitch_model: `preprocess.pitch.PitchCNN` with its weights
        ppg_model: `preprocess.ppg.PPGEncoder` with its weights
        sample_rate: must be SAMPLE_RATE; resampling is not ported
        features: subset of ('loudness', 'pitch', 'periodicity', 'ppg')
        loudness_bands: band count; None keeps full-band (n_freq) loudness
        config: a `config.Config`; None reads the environment's
        device: where to run; 'cuda' raises on a host without a card

    Returns
        the requested features in the order loudness (bands or n_freq, T),
        pitch (1, T) in Hz, periodicity (1, T), ppg (PPG_CHANNELS, T), as
        float32 tensors on `device`
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if sample_rate is not None and sample_rate != config.SAMPLE_RATE:
        raise NotImplementedError('Resampling is not ported')
    if loudness_bands == 'default':
        loudness_bands = config.LOUDNESS_BANDS
    if config.PITCH_ESTIMATOR != 'cnn':
        raise NotImplementedError('Only the CNN pitch estimator is ported')
    if not config.VITERBI_DECODE_PITCH:
        raise NotImplementedError('Only Viterbi pitch decoding is ported')
    unknown = set(features) - set(FEATURES)
    if unknown:
        raise NotImplementedError(f'Features {sorted(unknown)} are not ported')

    audio = torch.as_tensor(np.asarray(audio, np.float32)) \
        if not isinstance(audio, torch.Tensor) else audio.float()
    frames = audio.shape[-1] // config.HOPSIZE
    samples = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS) * \
        config.HOPSIZE
    padded = torch.zeros((audio.shape[0], samples), device=device)
    length = min(audio.shape[-1], samples)
    padded[:, :length] = audio[:, :length].to(device)

    out = {}
    with torch.no_grad():
        if 'loudness' in features:
            out['loudness'] = loudness_module.from_audio(
                padded, config, loudness_bands)
        if 'pitch' in features or 'periodicity' in features:
            scores = pitch_module.posteriorgram(
                pitch_model, padded, config.HOPSIZE)
            pitch, periodicity = pitch_module.decode(
                scores, config.FMIN, config.FMAX)
            out['pitch'], out['periodicity'] = pitch[None], periodicity[None]
        if 'ppg' in features:
            spectrogram = spectrogram_module.from_audio(padded[None], config)
            mels = spectrogram_module.linear_to_mel(spectrogram[0], config)
            log_probs = ppg_model(mels.transpose(0, 1)[None])
            out['ppg'] = torch.exp(log_probs[0].transpose(0, 1))
    return tuple(
        out[name][..., :frames] for name in FEATURES if name in features)
