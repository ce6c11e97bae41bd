"""Feature extraction (counterpart of `promonet_tpu/preprocess/core.py`)

For loudness, pitch, periodicity, the linear spectrogram and the PPG the
audio is zero-padded to a bucketed frame count, every feature is computed on the padded audio, and
the results are trimmed to the true frame count, as the JAX package's
fused extractor does. The padding changes the features of the last
frames, so the bucket ladder is part of the result. Harmonics and the
speaker embedding are computed on the unpadded audio. The `from_file*`
functions read wav files and save features under the JAX package's
cache names (`save`).
"""
from pathlib import Path

import numpy as np
import torch

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..data import bucket_frames
from ..utils import audio as audio_module
from ..utils import timer
from . import harmonics as harmonics_module
from . import loudness as loudness_module
from . import pitch as pitch_module
from . import speaker as speaker_module
from . import spectrogram as spectrogram_module

# Features computed on the bucket-padded audio
PADDED = ('loudness', 'pitch', 'periodicity', 'spectrogram', 'ppg')

# Every feature, in the order `from_audio` returns them
FEATURES = PADDED + ('harmonics', 'speaker')

# The features the entry points compute unless asked for others
DEFAULT_FEATURES = ('loudness', 'pitch', 'periodicity', 'ppg')


def from_audio(
    audio,
    pitch_model,
    ppg_model,
    sample_rate=None,
    features=DEFAULT_FEATURES,
    loudness_bands='default',
    max_harmonics=None,
    config=None,
    device='cuda',
    speaker_model=None
):
    """Preprocess audio (1, T) into interpretable features

    Arguments
        audio: (1, T) float waveform (numpy or tensor)
        pitch_model: `preprocess.pitch.PitchCNN` with its weights; may be
            None when config.PITCH_ESTIMATOR is 'dsp' or pitch is not asked
        ppg_model: `preprocess.ppg.PPGEncoder` with its weights; may be
            None when 'ppg' is not asked
        sample_rate: rate of `audio`; another rate than SAMPLE_RATE is
            resampled on the host first
        features: subset of FEATURES
        loudness_bands: band count; None keeps full-band (n_freq) loudness
        max_harmonics: number of harmonic contours; None takes the config's
        config: a `config.Config`; None reads the environment's
        device: where to run; 'cuda' raises on a host without a card
        speaker_model: `preprocess.speaker.SpeakerEncoder` with its
            weights, for 'speaker'; None resolves as
            `preprocess.speaker.from_audio` does

    Returns
        the requested features in the order loudness (bands or n_freq, T),
        pitch (1, T) in Hz, periodicity (1, T), spectrogram (n_freq, T)
        (magnitudes), ppg (PPG_CHANNELS, T),
        harmonics (max_harmonics, T) in Hz, speaker
        (WAVLM_EMBEDDING_CHANNELS,), as float32 tensors on `device`
    """
    with timer.span('preprocess'):
        device = device_module.resolve(device)
        config = config_module.default() if config is None else config
        if loudness_bands == 'default':
            loudness_bands = config.LOUDNESS_BANDS
        unknown = set(features) - set(FEATURES)
        if unknown:
            raise NotImplementedError(
                f'Features {sorted(unknown)} are not ported')

        if sample_rate is not None and sample_rate != config.SAMPLE_RATE:
            audio = audio_module.resample(
                _to_numpy(audio), sample_rate, config.SAMPLE_RATE)
        frames = audio.shape[-1] // config.HOPSIZE

        out = {}
        if any(name in features for name in PADDED):
            samples = bucket_frames(
                frames, config.INFERENCE_FRAME_BUCKETS) * config.HOPSIZE
            out = extract_padded(
                pad(audio, samples, device), pitch_model, ppg_model,
                features, loudness_bands, config)
            out = {name: value[..., :frames] for name, value in out.items()}
        if 'harmonics' in features:
            out['harmonics'] = harmonics_module.from_audio(
                _to_numpy(audio), max_harmonics=max_harmonics, config=config,
                device=device)
        if 'speaker' in features:
            out['speaker'] = speaker_module.from_audio(
                audio, speaker_model, config=config, device=device)
        return tuple(out[name] for name in FEATURES if name in features)


def from_file(
    file,
    pitch_model,
    ppg_model,
    features=DEFAULT_FEATURES,
    loudness_bands='default',
    config=None,
    device='cuda',
    speaker_model=None
):
    """Preprocess a wav file; see `from_audio`"""
    config = config_module.default() if config is None else config
    return from_audio(
        load.audio(file, config), pitch_model, ppg_model, features=features,
        loudness_bands=loudness_bands, config=config, device=device,
        speaker_model=speaker_model)


def from_file_to_file(
    file,
    pitch_model,
    ppg_model,
    output_prefix=None,
    features=DEFAULT_FEATURES,
    loudness_bands='default',
    config=None,
    device='cuda',
    speaker_model=None
):
    """Preprocess a wav file and save the features (see `save`)

    output_prefix None is the file's path without its suffix.
    """
    config = config_module.default() if config is None else config
    if output_prefix is None:
        output_prefix = Path(file).with_suffix('')
    values = from_file(
        file, pitch_model, ppg_model, features, loudness_bands, config,
        device, speaker_model)
    save(output_prefix, dict(zip(_ordered(features), values)), config)


def from_files_to_files(
    files,
    pitch_model,
    ppg_model,
    output_prefixes=None,
    features=DEFAULT_FEATURES,
    loudness_bands='default',
    config=None,
    device='cuda',
    speaker_model=None
):
    """Preprocess several wav files and save their features, in turn"""
    if output_prefixes is None:
        output_prefixes = [Path(file).with_suffix('') for file in files]
    for file, output_prefix in zip(files, output_prefixes):
        from_file_to_file(
            file, pitch_model, ppg_model, output_prefix, features,
            loudness_bands, config, device, speaker_model)


def save(output_prefix, feature_values, config=None):
    """Save named features under the JAX package's cache names

    `{prefix}-{name}.npy`, with `-viterbi` before `-pitch` and
    `-periodicity` when config.VITERBI_DECODE_PITCH is set; text goes to
    `{prefix}.txt`.
    """
    config = config_module.default() if config is None else config
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    for name, value in feature_values.items():
        if name == 'text':
            with open(f'{output_prefix}.txt', 'w', encoding='utf-8') as file:
                file.write(value)
        elif name in ('pitch', 'periodicity'):
            load.save_array(f'{output_prefix}{viterbi}-{name}.npy', value)
        else:
            load.save_array(f'{output_prefix}-{name}.npy', value)


def _ordered(features):
    """Feature names in the order `from_audio` returns them"""
    order = [
        'loudness', 'pitch', 'periodicity', 'spectrogram', 'ppg', 'text',
        'harmonics', 'speaker']
    return [name for name in order if name in features]


def pad(audio, samples, device):
    """Audio (1, T) as a float32 tensor of `samples` samples on `device`

    Zero-padded or cut at the end.
    """
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    audio = audio[:, :samples].to(device).float()
    return torch.nn.functional.pad(audio, (0, samples - audio.shape[-1]))


def extract_padded(
    audio, pitch_model, ppg_model, features, loudness_bands, config
):
    """The PADDED features of bucket-padded audio (1, T), untrimmed

    Returns {name: tensor}. Pitch is interpolated through unvoiced frames
    only when it is not Viterbi-decoded, as in the JAX package's fused
    extractor. The stages are the spans `preprocess.loudness`,
    `preprocess.pitch` (the pitch front end, its decode and refinement)
    and `preprocess.ppg` (the spectrogram, the mels and the PPG encoder).
    """
    out = {}
    with torch.no_grad():
        if 'loudness' in features:
            with timer.span('preprocess.loudness'):
                out['loudness'] = loudness_module.from_audio(
                    audio, config, loudness_bands)
        if 'pitch' in features or 'periodicity' in features:
            if config.VITERBI_DECODE_PITCH:
                decoder, interp_at = 'viterbi', None
            else:
                decoder, interp_at = 'argmax', config.VOICING_THRESHOLD
            with timer.span('preprocess.pitch'):
                out['pitch'], out['periodicity'] = pitch_module.estimate(
                    audio, pitch_model, config, decoder, interp_at)
        if 'spectrogram' in features or 'ppg' in features:
            with timer.span('preprocess.ppg'):
                spectrogram = spectrogram_module.from_audio(
                    audio[None], config)[0]
                if 'spectrogram' in features:
                    out['spectrogram'] = spectrogram
                if 'ppg' in features:
                    mels = spectrogram_module.linear_to_mel(
                        spectrogram, config)
                    log_probs = ppg_model(mels.transpose(0, 1)[None])
                    out['ppg'] = torch.exp(log_probs[0].transpose(0, 1))
    return out


def _to_numpy(audio):
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio)
