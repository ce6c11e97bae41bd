"""Prosody figures (counterpart of `promonet_tpu/plot/core.py`)

One panel per feature (waveform, loudness, pitch, periodicity, PPG),
each with its target overlaid where one is given, and the frames whose
error passes the configuration's ERROR_THRESHOLD_* shaded red. The
inputs may be tensors, on any device, or arrays: they are drawn on the
host. matplotlib is imported inside the functions, with the Agg backend,
so that the package imports without it.
"""
import numpy as np
import torch

from .. import config as config_module
from .. import load


def _host(value):
    """A tensor or array as a numpy array on the host"""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if not value.dtype.is_floating_point or value.dtype in (
                torch.bfloat16, torch.float16):
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def from_features(
    audio=None,
    loudness=None,
    pitch=None,
    periodicity=None,
    ppg=None,
    target_loudness=None,
    target_pitch=None,
    target_periodicity=None,
    target_ppg=None,
    features=None,
    config=None
):
    """The prosody figure of the given features, a matplotlib Figure

    features: the panels, in order (None: config.DEFAULT_PLOT_FEATURES);
    a panel whose feature is not given is left out. Loudness of several
    bands is drawn as its mean over the bands. The error shading compares
    loudness in dB, pitch in cents and periodicity absolutely against
    config.ERROR_THRESHOLD_{LOUDNESS,PITCH,PERIODICITY}.
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    config = config_module.default() if config is None else config
    if features is None:
        features = config.DEFAULT_PLOT_FEATURES
    available = {
        name: None if value is None else _host(value)
        for name, value in (
            ('audio', audio), ('loudness', loudness), ('pitch', pitch),
            ('periodicity', periodicity), ('ppg', ppg))}
    targets = {
        name: None if value is None else _host(value)
        for name, value in (
            ('loudness', target_loudness), ('pitch', target_pitch),
            ('periodicity', target_periodicity))}
    panels = [f for f in features if available.get(f) is not None]
    if not panels:
        panels = [f for f in features if f in available]
    figure, axes = plt.subplots(
        len(panels), 1, figsize=(10, 2 * len(panels)), sharex=False)
    if len(panels) == 1:
        axes = [axes]

    for axis, name in zip(axes, panels):
        axis.set_ylabel(name)
        values = available[name]
        target = targets.get(name)
        if values is None:
            continue
        if name == 'audio':
            axis.plot(values.reshape(-1), linewidth=.5)
        elif name == 'loudness':
            if values.ndim > 1:
                values = values.mean(axis=-2)
            axis.plot(values.reshape(-1))
            if target is not None:
                if target.ndim > 1:
                    target = target.mean(axis=-2)
                target = target.reshape(-1)
                axis.plot(target, alpha=.5)
                _highlight(
                    axis,
                    np.abs(values.reshape(-1)[:len(target)] - target),
                    config.ERROR_THRESHOLD_LOUDNESS)
        elif name == 'pitch':
            values = values.reshape(-1)
            axis.plot(values)
            if target is not None:
                target = target.reshape(-1)
                axis.plot(target, alpha=.5)
                cents = 1200 * np.abs(
                    np.log2(values[:len(target)]) - np.log2(target))
                _highlight(axis, cents, config.ERROR_THRESHOLD_PITCH)
        elif name == 'periodicity':
            values = values.reshape(-1)
            axis.plot(values)
            if target is not None:
                target = target.reshape(-1)
                axis.plot(target, alpha=.5)
                _highlight(
                    axis,
                    np.abs(values[:len(target)] - target),
                    config.ERROR_THRESHOLD_PERIODICITY)
        elif name == 'ppg':
            axis.imshow(
                values, aspect='auto', origin='lower',
                interpolation='nearest')
    figure.tight_layout()
    return figure


def _highlight(axis, errors, threshold):
    """Shade the frames whose error passes the threshold"""
    for frame in np.where(errors > threshold)[0]:
        axis.axvspan(frame - .5, frame + .5, color='red', alpha=.15, lw=0)


def from_file_to_file(
    output_file,
    audio_file=None,
    prefix=None,
    target_prefix=None,
    features=None,
    config=None
):
    """Draw the features saved under cache prefixes (`load.features`) and
    a wav file (`load.audio`), and save the figure to `output_file`"""
    config = config_module.default() if config is None else config
    kwargs = {}
    if audio_file is not None:
        kwargs['audio'] = load.audio(audio_file, config)
    if prefix is not None:
        (
            kwargs['loudness'],
            kwargs['pitch'],
            kwargs['periodicity'],
            kwargs['ppg']
        ) = load.features(prefix, config)
    if target_prefix is not None:
        (
            kwargs['target_loudness'],
            kwargs['target_pitch'],
            kwargs['target_periodicity'],
            kwargs['target_ppg']
        ) = load.features(target_prefix, config)
    figure = from_features(features=features, config=config, **kwargs)
    figure.savefig(output_file, bbox_inches='tight', dpi=150)
    import matplotlib.pyplot as plt
    plt.close(figure)
