"""Dataset preprocessing (counterpart of `promonet_tpu/data/preprocess`)

The features of every cached wav of a dataset, written beside it under
the cache's names: full-band loudness (loudness_bands=None), pitch,
periodicity, the linear spectrogram and the PPG.
"""
from ... import config as config_module
from ... import load
from ... import preprocess
from ...utils.notify import notify

FEATURES = ('loudness', 'pitch', 'periodicity', 'spectrogram', 'ppg')


@notify('preprocess')
def datasets(
    datasets=None,
    features=FEATURES,
    pitch_model=None,
    ppg_model=None,
    config=None,
    device='cuda'
):
    """Preprocess each dataset of `datasets` (None: config.DATASETS)

    pitch_model and ppg_model None take `load.pitch_model` and
    `load.ppg_model` of config, where the features need them. The run is
    reported by `utils.notify` ('preprocess').
    """
    config = config_module.default() if config is None else config
    if pitch_model is None and config.PITCH_ESTIMATOR == 'cnn' and (
            'pitch' in features or 'periodicity' in features):
        pitch_model = load.pitch_model(config=config, device=device)
    if ppg_model is None and 'ppg' in features:
        ppg_model = load.ppg_model(config=config, device=device)
    for name in config.DATASETS if datasets is None else datasets:
        wavs = sorted((config.CACHE_DIR / name).glob('*/*.wav'))
        preprocess.from_files_to_files(
            wavs, pitch_model, ppg_model, [wav.parent / wav.stem
                                           for wav in wavs],
            features, loudness_bands=None, config=config, device=device)
