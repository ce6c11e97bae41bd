"""Speech synthesis (counterpart of `promonet_tpu/synthesize/core.py`)

`from_features` and `generate` follow the JAX package's exact-length
path: features are padded to a bucketed frame count, the generator runs
over the bucket, and the audio is trimmed to frames * HOPSIZE samples.
"""
import numpy as np
import torch

from .. import device as device_module
from ..data import bucket_frames


def from_features(
    loudness,
    pitch,
    periodicity,
    ppg,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    output_dtype='float32',
    device='cuda'
):
    """Synthesize speech

    Arguments
        loudness: (F, T) loudness contour
        pitch: (1, T) pitch contour in Hz
        periodicity: (1, T) periodicity contour
        ppg: (C, T) phonetic posteriorgram
        generator: `models.Generator` with its weights, on `device`
        speaker: integer speaker id
        spectral_balance_ratio: (0, 2] spectral balance / formant ratio
        loudness_ratio: loudness ratio
        output_dtype: 'float32', or 'int16' for the PCM16 wire format
        device: where to run; 'cuda' raises on a host without a card

    Returns
        audio: (1, T * HOPSIZE) numpy array
    """
    audio = generate(
        loudness, pitch, periodicity, ppg, generator, speaker,
        spectral_balance_ratio, loudness_ratio, device)
    if output_dtype == 'int16':
        audio = np.clip(
            np.round(audio * 32767.), -32768., 32767.).astype(np.int16)
    return audio


def generate(
    loudness,
    pitch,
    periodicity,
    ppg,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda'
):
    """Generate speech with padding to bucketed lengths; numpy (1, samples)"""
    device = device_module.resolve(device)
    config = generator.config
    frames = pitch.shape[-1]
    bucket = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)

    def pad(x, nan=None):
        x = torch.as_tensor(np.asarray(x, np.float32)) \
            if not isinstance(x, torch.Tensor) else x.float()
        x = x.to(device)
        if nan is not None:
            x = torch.nan_to_num(x, nan=nan)
        return torch.nn.functional.pad(x, (0, bucket - x.shape[-1]))[None]

    with torch.no_grad():
        audio = generator(
            pad(loudness),
            pad(pitch.reshape(-1), nan=100.),
            pad(periodicity.reshape(-1)),
            pad(ppg),
            torch.tensor([speaker], dtype=torch.long, device=device),
            torch.tensor([spectral_balance_ratio], device=device),
            torch.tensor([loudness_ratio], device=device))
    return audio[0, :, :frames * config.HOPSIZE].cpu().numpy()
