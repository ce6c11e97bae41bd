"""Streaming synthesis (counterpart of `promonet_tpu/synthesize/stream.py`)

`Streamer` is windowed: each step runs the generator over exactly
[left context | chunk | right context] frames and keeps the chunk's
samples, so a convolutional backbone sees real context on both sides
and the audio lags the features by the right context. `FARGANStreamer`
carries FARGAN's recurrent state from chunk to chunk instead: no
context, no recomputation, a latency of one chunk.

Features are gathered on the host as numpy; each step copies one window
to the device and its audio back.
"""
import numpy as np
import torch

from .. import device as device_module
from .core import speaker_tensor


class Streamer:
    """Frame-at-a-time synthesis with bounded latency

    Usage:
        streamer = Streamer(generator, speaker=3)
        for features in feature_chunks:
            audio = streamer.feed(*features)   # may be empty
        audio = streamer.flush()
    """

    def __init__(
        self,
        generator,
        speaker=0,
        spectral_balance_ratio=1.,
        loudness_ratio=1.,
        chunk_frames=32,
        left_frames=16,
        right_frames=16,
        device='cuda'
    ):
        """
        Arguments
            generator: `models.Generator` with its weights, on `device`
            speaker, spectral_balance_ratio, loudness_ratio: as in
                `synthesize.from_features` (an id, or under ZERO_SHOT a
                (512,) x-vector)
            chunk_frames: frames emitted per step
            left_frames, right_frames: context frames on either side
            device: where to run; 'cuda' raises on a host without a card
        """
        self.device = device_module.resolve(device)
        self.generator = generator
        self.hopsize = generator.config.HOPSIZE
        self.sample_rate = generator.config.SAMPLE_RATE
        self.chunk = chunk_frames
        self.left = left_frames
        self.right = right_frames
        self.window = left_frames + chunk_frames + right_frames
        self.conditions = _conditions(
            speaker, spectral_balance_ratio, loudness_ratio,
            generator.config, self.device)

        # Feature frames not yet emitted; left context of the next window
        self._pending = None
        self._history = None

    @property
    def latency_seconds(self):
        """Algorithmic emission latency: the right context"""
        return self.right * self.hopsize / self.sample_rate

    def feed(self, loudness, pitch, periodicity, ppg):
        """Append feature frames; return the audio now synthesizable

        Features use the standard layouts: loudness (F, T), pitch (T,)
        or (1, T), periodicity likewise, ppg (C, T).

        Returns
            (1, samples) float32 numpy audio, possibly empty
        """
        self._pending = _append(
            self._pending, _stack(loudness, pitch, periodicity, ppg))
        outputs = []
        while self._frames_available() >= self.chunk + self.right:
            outputs.append(self._emit())
        return _concatenate(outputs)

    def flush(self):
        """Synthesize every pending frame, padded by replication

        Ends the stream: the next `feed` starts a new one.
        """
        outputs = []
        while self._frames_available() > 0:
            remaining = min(self._frames_available(), self.chunk)
            pad = self.chunk + self.right - self._frames_available()
            if pad > 0:
                self._pending = tuple(
                    np.concatenate(
                        [a, np.repeat(a[..., -1:], pad, axis=-1)], axis=-1)
                    for a in self._pending)
            outputs.append(self._emit()[..., :remaining * self.hopsize])
            # Drop the replicated frames that are still pending
            if pad > 0:
                self._pending = tuple(
                    a[..., :max(0, a.shape[-1] - pad)]
                    for a in self._pending)
        self._pending = None
        self._history = None
        return _concatenate(outputs)

    def _frames_available(self):
        return 0 if self._pending is None else self._pending[1].shape[-1]

    def _emit(self):
        """Run one window; advance by one chunk"""
        window = tuple(a[..., :self.chunk + self.right] for a in self._pending)
        if self._history is None:
            # The first frame, replicated, is the first left context
            history = tuple(
                np.repeat(a[..., :1], self.left, axis=-1) for a in window)
        else:
            history = self._history
        full = tuple(
            np.concatenate([h, w], axis=-1)[..., :self.window]
            for h, w in zip(history, window))
        start = self.left * self.hopsize
        audio = self._step(full)[..., start:start + self.chunk * self.hopsize]

        # Next left context: the last `left` frames up to the chunk's end
        self._history = tuple(
            np.concatenate([h, a[..., :self.chunk]], axis=-1)[..., -self.left:]
            for h, a in zip(history, self._pending))
        self._pending = tuple(a[..., self.chunk:] for a in self._pending)
        return audio

    def _step(self, features):
        """The generator over exactly these frames; (1, T * HOPSIZE) numpy"""
        loudness, pitch, periodicity, ppg = (
            torch.from_numpy(a).to(self.device) for a in features)
        with torch.no_grad():
            audio = self.generator(
                loudness[None], pitch, periodicity, ppg[None],
                *self.conditions)
        return audio[0].cpu().numpy()


class FARGANStreamer:
    """Exact-state streaming for the FARGAN backbone

    Each whole chunk of fed frames runs through FARGAN from the carry the
    chunk before it left (its sample history and recurrent states), so
    the stream takes the path of one offline pass. The audio is not
    bit-identical to it: the conditioning network's products run over
    other row counts.
    """

    def __init__(
        self,
        generator,
        speaker=0,
        spectral_balance_ratio=1.,
        loudness_ratio=1.,
        chunk_frames=32,
        device='cuda'
    ):
        if generator.config.MODEL != 'fargan':
            raise ValueError(
                "FARGANStreamer needs a generator with MODEL='fargan'; use "
                'Streamer (windowed) for convolutional backbones')
        self.device = device_module.resolve(device)
        self.generator = generator
        self.hopsize = generator.config.HOPSIZE
        self.sample_rate = generator.config.SAMPLE_RATE
        self.chunk = chunk_frames
        self.conditions = _conditions(
            speaker, spectral_balance_ratio, loudness_ratio,
            generator.config, self.device)
        self._pending = None
        self._carry = generator.backbone.initial_states(
            1, generator.dtype, self.device)

    @property
    def latency_seconds(self):
        """Algorithmic latency: one chunk"""
        return self.chunk * self.hopsize / self.sample_rate

    def feed(self, loudness, pitch, periodicity, ppg):
        """Append feature frames; return the audio of every whole chunk"""
        self._pending = _append(
            self._pending, _stack(loudness, pitch, periodicity, ppg))
        outputs = []
        while self._pending[1].shape[-1] >= self.chunk:
            window = tuple(a[..., :self.chunk] for a in self._pending)
            self._pending = tuple(a[..., self.chunk:] for a in self._pending)
            audio, self._carry = self._step(window)
            outputs.append(audio)
        return _concatenate(outputs)

    def flush(self):
        """Synthesize the remaining (< chunk) frames

        The tail is zero-padded to a chunk and the padding's samples are
        dropped: the recurrence is causal, so the true frames' samples do
        not depend on it. The carry stays where the last whole chunk left
        it.
        """
        remaining = 0 if self._pending is None else self._pending[1].shape[-1]
        if remaining == 0:
            self._pending = None
            return _concatenate([])
        pad = self.chunk - remaining
        window = tuple(
            np.concatenate(
                [a, np.zeros(a.shape[:-1] + (pad,), a.dtype)], axis=-1)
            for a in self._pending)
        audio, _ = self._step(window)
        self._pending = None
        return audio[..., :remaining * self.hopsize]

    def _step(self, features):
        loudness, pitch, periodicity, ppg = (
            torch.from_numpy(a).to(self.device) for a in features)
        with torch.no_grad():
            audio, carry = self.generator(
                loudness[None], pitch, periodicity, ppg[None],
                *self.conditions, initial_states=self._carry,
                return_states=True)
        return audio[0].cpu().numpy(), carry


def _conditions(
    speaker, spectral_balance_ratio, loudness_ratio, config, device
):
    """Speaker and ratio tensors of a single-row generator call"""
    return (
        speaker_tensor([speaker], config, device),
        torch.tensor([spectral_balance_ratio], device=device),
        torch.tensor([loudness_ratio], device=device))


def _stack(loudness, pitch, periodicity, ppg):
    """Features as float32 numpy, pitch and periodicity as (1, T)"""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    return (
        host(loudness), host(pitch).reshape(1, -1),
        host(periodicity).reshape(1, -1), host(ppg))


def _append(pending, incoming):
    if pending is None:
        return incoming
    return tuple(
        np.concatenate([a, b], axis=-1) for a, b in zip(pending, incoming))


def _concatenate(outputs):
    if not outputs:
        return np.zeros((1, 0), np.float32)
    return np.concatenate(outputs, axis=-1)
