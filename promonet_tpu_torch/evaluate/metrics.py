"""Objective evaluation metrics (counterpart of
`promonet_tpu/evaluate/metrics.py`)

Each metric is a streaming accumulator: `update` adds utterances,
`__call__` gives the value, `reset` clears it. Sums are float64 on the
host, as in the JAX package; the PPG distance is computed in float32 on
the CPU (sparsify, then `ops.sparse.jensen_shannon`) and summed there.
Inputs are numpy arrays or tensors; tensors are copied to the host.
"""
import numpy as np
import torch

from .. import config as config_module
from ..ops import sparse
from ..preprocess import text as text_module


class Metrics:
    """Loudness, periodicity, pitch, PPG and (optionally) word error

    Arguments
        include_wer: score transcripts (`update`'s text arguments)
        config: a `config.Config` (voicing threshold, PPG sparsity); None
            reads the environment's
    """

    def __init__(self, include_wer=True, config=None):
        config = config_module.default() if config is None else config
        self.loudness = Loudness()
        self.periodicity = RMSE()
        self.pitch = Pitch(config.VOICING_THRESHOLD)
        self.ppg = PPG(config.SPARSE_PPG_METHOD, config.SPARSE_PPG_THRESHOLD)
        self.wer = WER() if include_wer else None

    def __call__(self):
        result = {
            'loudness': self.loudness(),
            'periodicity': self.periodicity(),
            'pitch': self.pitch(),
            'ppg': self.ppg()}
        if self.wer is not None and self.wer.count:
            result['wer'] = self.wer()
        return result

    def update(
        self,
        loudness,
        predicted_loudness,
        pitch,
        periodicity,
        predicted_pitch,
        predicted_periodicity,
        ppg,
        predicted_ppg,
        text=None,
        predicted_text=None
    ):
        self.loudness.update(loudness, predicted_loudness)
        self.periodicity.update(periodicity, predicted_periodicity)
        self.pitch.update(
            pitch, periodicity, predicted_pitch, predicted_periodicity)
        self.ppg.update(ppg, predicted_ppg)
        if self.wer is not None and text and predicted_text:
            self.wer.update(text, predicted_text)

    def reset(self):
        self.loudness.reset()
        self.periodicity.reset()
        self.pitch.reset()
        self.ppg.reset()
        if self.wer is not None:
            self.wer.reset()


class Loudness:
    """Loudness RMSE in dB, with a loud/quiet split at -60 dB"""

    THRESHOLD = -60.

    def __init__(self):
        self.reset()

    def __call__(self):
        result = {'loudness': float(np.sqrt(self.total / max(self.count, 1)))}
        if self.loud_count:
            result['loudness-loud'] = float(
                np.sqrt(self.loud_total / self.loud_count))
        if self.quiet_count:
            result['loudness-quiet'] = float(
                np.sqrt(self.quiet_total / self.quiet_count))
        return result

    def update(self, target, predicted):
        target = _float64(target)
        predicted = _float64(predicted)
        length = min(len(target), len(predicted))
        target, predicted = target[:length], predicted[:length]
        square = (target - predicted) ** 2
        self.total += square.sum()
        self.count += length
        loud = target > self.THRESHOLD
        self.loud_total += square[loud].sum()
        self.loud_count += int(loud.sum())
        self.quiet_total += square[~loud].sum()
        self.quiet_count += int((~loud).sum())

    def reset(self):
        self.total = self.count = 0
        self.loud_total = self.loud_count = 0
        self.quiet_total = self.quiet_count = 0


class RMSE:
    """Streaming root-mean-square error"""

    def __init__(self):
        self.reset()

    def __call__(self):
        return float(np.sqrt(self.total / max(self.count, 1)))

    def update(self, target, predicted):
        target = _float64(target)
        predicted = _float64(predicted)
        length = min(len(target), len(predicted))
        self.total += ((target[:length] - predicted[:length]) ** 2).sum()
        self.count += length

    def reset(self):
        self.total = 0.
        self.count = 0


class Pitch:
    """Mean absolute pitch error in cents over co-voiced frames: frames
    where target and prediction both have periodicity above the voicing
    threshold. An utterance with no such frame adds nothing."""

    def __init__(self, voicing_threshold):
        self.voicing_threshold = voicing_threshold
        self.reset()

    def __call__(self):
        return float(self.total / max(self.count, 1))

    def update(
        self,
        target_pitch,
        target_periodicity,
        predicted_pitch,
        predicted_periodicity
    ):
        target_pitch = _float64(target_pitch)
        predicted_pitch = _float64(predicted_pitch)
        target_periodicity = _host(target_periodicity).reshape(-1)
        predicted_periodicity = _host(predicted_periodicity).reshape(-1)
        length = min(len(target_pitch), len(predicted_pitch))
        voicing = (
            (target_periodicity[:length] > self.voicing_threshold) &
            (predicted_periodicity[:length] > self.voicing_threshold))
        if not voicing.any():
            return
        cents = 1200 * np.abs(
            np.log2(predicted_pitch[:length][voicing]) -
            np.log2(target_pitch[:length][voicing]))
        self.total += cents.sum()
        self.count += int(voicing.sum())

    def reset(self):
        self.total = 0.
        self.count = 0


class PPG:
    """Mean Jensen-Shannon distance between sparsified PPG frames"""

    def __init__(self, method='percentile', threshold=0.85):
        self.method = method
        self.threshold = threshold
        self.reset()

    def __call__(self):
        return float(self.total / max(self.count, 1))

    def update(self, target, predicted):
        target = torch.as_tensor(_host(target), dtype=torch.float32)
        predicted = torch.as_tensor(_host(predicted), dtype=torch.float32)
        length = min(target.shape[-1], predicted.shape[-1])
        distance = sparse.jensen_shannon(
            sparse.sparsify(
                target[..., :length], self.method, self.threshold),
            sparse.sparsify(
                predicted[..., :length], self.method, self.threshold))
        self.total += float(torch.sum(distance))
        self.count += int(distance.numel())

    def reset(self):
        self.total = 0.
        self.count = 0


class WER:
    """Word error rate: token Levenshtein distance over the reference's
    token count, averaged over utterances"""

    def __init__(self):
        self.reset()

    def __call__(self):
        return float(self.total / max(self.count, 1))

    def update(self, target_text, predicted_text):
        target = text_module.normalize(target_text).split()
        predicted = text_module.normalize(predicted_text).split()
        if not target:
            return
        self.total += _levenshtein(target, predicted) / len(target)
        self.count += 1

    def reset(self):
        self.total = 0.
        self.count = 0


class SpectralBalance:
    """Correlation of target and predicted spectral centroids

    Not in the default bundle, as in the JAX package.
    """

    def __init__(self, config=None):
        self.config = config_module.default() if config is None else config
        self.reset()

    def __call__(self):
        if self.count < 2:
            return 0.
        stacked = np.asarray(self.pairs)
        return float(np.corrcoef(stacked[:, 0], stacked[:, 1])[0, 1])

    def update(self, target_audio, predicted_audio):
        self.pairs.append((
            _centroid(target_audio, self.config),
            _centroid(predicted_audio, self.config)))
        self.count += 1

    def reset(self):
        self.pairs = []
        self.count = 0


def _centroid(audio, config):
    """Spectral centroid of audio (1, T) in Hz, over the whole utterance"""
    from ..preprocess import spectrogram as spectrogram_module

    audio = torch.as_tensor(_host(audio), dtype=torch.float32)
    magnitudes = np.abs(spectrogram_module.from_audio(audio, config).numpy())
    frequencies = np.linspace(0, config.SAMPLE_RATE / 2, magnitudes.shape[-2])
    return float(
        (frequencies[:, None] * magnitudes).sum() /
        np.clip(magnitudes.sum(), 1e-9, None))


def _levenshtein(a, b):
    """Edit distance over token sequences"""
    m, n = len(a), len(b)
    previous = list(range(n + 1))
    for i in range(1, m + 1):
        current = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            current[j] = min(
                previous[j] + 1,
                current[j - 1] + 1,
                previous[j - 1] + cost)
        previous = current
    return previous[n]


def _host(value):
    """A tensor or array as a numpy array"""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _float64(value):
    return np.asarray(_host(value), np.float64).reshape(-1)
