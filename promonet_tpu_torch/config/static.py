"""Values derived from the merged configuration.

Mirrors `promonet_tpu/config/static.py` for the constants the port
reads.
"""
import math

# Names computed here; an override of one of them is recomputed
DERIVED = (
    'LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD',
    'LOG_FMIN',
    'LOG_FMAX',
    'GLOBAL_CHANNELS',
    'NUM_FEATURES',
    'NUM_PREVIOUS_SAMPLES')

_NUM_SPEAKERS_BY_DATASET = {
    'daps': 20,
    'libritts': 1230,
    'vctk': 109}


def derive(values):
    """Derived constants of a dict of UPPERCASE configuration values"""
    threshold = values['DYNAMIC_RANGE_COMPRESSION_THRESHOLD']
    features = values['INPUT_FEATURES']
    derived = {
        'LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD':
            None if threshold is None else math.log(threshold),
        'LOG_FMIN': math.log2(values['FMIN']),
        'LOG_FMAX': math.log2(values['FMAX']),
        'GLOBAL_CHANNELS': (
            values['SPEAKER_CHANNELS'] +
            values['AUGMENT_PITCH'] +
            values['AUGMENT_LOUDNESS']),
        'NUM_FEATURES': (
            values['NUM_MELS'] if values['SPECTROGRAM_ONLY'] else (
                values['PPG_CHANNELS'] +
                ('loudness' in features) * values['LOUDNESS_BANDS'] +
                ('periodicity' in features) +
                ('pitch' in features) * (
                    values['PITCH_EMBEDDING_SIZE']
                    if values['PITCH_EMBEDDING'] else 1))),
        # Samples of history an autoregressive backbone takes
        'NUM_PREVIOUS_SAMPLES': {
            'cargan': values['CARGAN_INPUT_SIZE'],
            'fargan': values['HOPSIZE'] * values['FARGAN_PREVIOUS_FRAMES']
        }.get(values['MODEL'], 1)}

    # A config file may pin the speaker count; else it follows the dataset
    if 'NUM_SPEAKERS' not in values:
        dataset = values['TRAINING_DATASET']
        counts = dict(
            _NUM_SPEAKERS_BY_DATASET, synthetic=values['SYNTHETIC_SPEAKERS'])
        derived['NUM_SPEAKERS'] = counts.get(dataset, 1)
    return derived
