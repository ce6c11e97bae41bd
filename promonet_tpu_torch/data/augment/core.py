"""Pitch and loudness augmentation (counterpart of
`promonet_tpu/data/augment/core.py`)

Each original utterance of a cached dataset ('-100' stems) gets a
pitch-shifted copy '<stem>-p<ratio x 100>.wav' (resampled by the ratio
and played back at the original rate) and a loudness-scaled copy
'<stem>-l<ratio x 100>.wav', with ratios log-uniform in
[AUGMENTATION_RATIO_MIN, AUGMENTATION_RATIO_MAX] from
numpy.random.default_rng(RANDOM_SEED). The ratios go to the port's
config.AUGMENT_DIR / '<dataset>-{pitch,loudness}.json'; the JAX
package's shipped files are never written.
"""
import json

import numpy as np

from ... import config as config_module
from ...utils import audio as audio_module
from ...utils.notify import notify


def sample(count, rng, config):
    """`count` ratios, log-uniform; a ratio that rounds to 1.00 becomes
    1.01, since the key 100 would be the original's suffix"""
    ratios = 2 ** rng.uniform(
        np.log2(config.AUGMENTATION_RATIO_MIN),
        np.log2(config.AUGMENTATION_RATIO_MAX),
        count)
    result = []
    for ratio in ratios:
        key = int(round(ratio * 100))
        if key == 100:
            key = 101
        result.append(key / 100.)
    return result


def pitch_shift(audio, ratio, sample_rate):
    """Resample by 1 / ratio, to be played back at `sample_rate`"""
    return audio_module.resample(
        audio, int(round(sample_rate * ratio)), sample_rate)


def loudness_shift(audio, ratio):
    """Scale by the perceptual ratio (10 log2(ratio) dB); a peak over 1 is
    brought to 0.999"""
    gain = 2 ** ((10 * np.log2(ratio)) / 10)
    shifted = np.asarray(audio) * gain
    peak = np.abs(shifted).max()
    if peak > 1.:
        shifted = shifted / peak * 0.999
    return shifted.astype(np.float32)


def from_files_to_files(audio_files, output_files, ratios, kind, config):
    """Augment each audio file by its ratio and write the result"""
    for audio_file, output_file, ratio in zip(
        audio_files, output_files, ratios
    ):
        audio, sample_rate = audio_module.load(audio_file, config.SAMPLE_RATE)
        if kind == 'pitch':
            augmented = pitch_shift(audio, ratio, config.SAMPLE_RATE)
        else:
            augmented = loudness_shift(audio, ratio)
        audio_module.save(output_file, augmented, sample_rate)


@notify('augment')
def datasets(datasets=None, config=None):
    """Augment the cached datasets of `datasets` (None: config.DATASETS)
    and write their ratio files; reported by `utils.notify` ('augment')"""
    config = config_module.default() if config is None else config
    rng = np.random.default_rng(config.RANDOM_SEED)
    for name in config.DATASETS if datasets is None else datasets:
        cache = config.CACHE_DIR / name
        if not cache.exists():
            continue
        wavs = sorted(
            wav for wav in cache.glob('*/*.wav') if wav.stem.endswith('-100'))
        for kind, enabled in (
            ('pitch', config.AUGMENT_PITCH),
            ('loudness', config.AUGMENT_LOUDNESS)
        ):
            if not enabled:
                continue
            ratios = sample(len(wavs), rng, config)
            mapping, outputs = {}, []
            for wav, ratio in zip(wavs, ratios):
                stem = f'{wav.parent.name}/{wav.stem}'
                mapping[stem] = int(round(ratio * 100))
                outputs.append(
                    wav.parent / f'{wav.stem}-{kind[0]}{mapping[stem]}.wav')
            from_files_to_files(wavs, outputs, ratios, kind, config)
            file = config.AUGMENT_DIR / f'{name}-{kind}.json'
            file.parent.mkdir(parents=True, exist_ok=True)
            with open(file, 'w') as handle:
                json.dump(mapping, handle, indent=4, sort_keys=True)
