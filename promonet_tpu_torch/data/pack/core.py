"""Pack features into one frame-rate tensor (counterpart of
`promonet_tpu/data/pack/core.py`)

LOUDNESS_BANDS loudness bands, pitch, periodicity, PPG_CHANNELS PPG
channels, the speaker and the two augmentation ratios
(`models.export.labels`), written as `.npy` or as `.csv` with a time
column and the labels as its header.
"""
from pathlib import Path

import numpy as np
import torch

from ... import config as config_module
from ... import load
from ...models.export import labels, pack_features


def from_features(
    loudness,
    pitch,
    periodicity,
    ppg,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    config=None
):
    """Pack one utterance's features → (1, len(labels()), T) float32

    loudness (F, T) or (1, F, T), pitch and periodicity (T,) or (1, T),
    ppg (C, T) or (1, C, T); arrays or tensors.
    """
    loudness = torch.as_tensor(np.asarray(loudness, np.float32))
    if loudness.dim() == 2:
        loudness = loudness[None]
    pitch = torch.as_tensor(np.asarray(pitch, np.float32)).reshape(1, -1)
    periodicity = torch.as_tensor(
        np.asarray(periodicity, np.float32)).reshape(1, -1)
    ppg = torch.as_tensor(np.asarray(ppg, np.float32))
    if ppg.dim() == 2:
        ppg = ppg[None]
    return pack_features(
        loudness, pitch, periodicity, ppg, torch.tensor([speaker]),
        torch.tensor([spectral_balance_ratio]),
        torch.tensor([loudness_ratio]), config)


def from_file_to_file(prefix, output_file, config=None, **kwargs):
    """Pack the features saved under a cache prefix (`load.features`) and
    write them to output_file: `.csv` (a time column, then one column per
    label), `.pt` (a tensor) or otherwise `.npy` (that suffix replacing
    any other); kwargs as `from_features` takes them"""
    config = config_module.default() if config is None else config
    features = load.features(prefix, config)
    packed = from_features(*features, config=config, **kwargs)[0].numpy()
    output_file = str(output_file)
    if output_file.endswith('.csv'):
        times = np.arange(packed.shape[-1]) * (
            config.HOPSIZE / config.SAMPLE_RATE)
        header = 'time,' + ','.join(labels(config))
        rows = np.concatenate([times[None], packed], axis=0).T
        np.savetxt(
            output_file, rows, delimiter=',', header=header, comments='')
    elif output_file.endswith('.pt'):
        torch.save(torch.from_numpy(packed), output_file)
    else:
        np.save(Path(output_file).with_suffix('.npy'), packed)
