"""Pitch and periodicity estimation

Counterpart of `promonet_tpu/preprocess/pitch.py`. Two front ends score
each frame over 256 log-spaced candidate frequencies: the learned
`PitchCNN` on 1024-sample frames ('cnn', `cnn_posteriorgram`) and the
normalized cross-correlation ('dsp', `posteriorgram`, shared with the
harmonics analysis through `ncc`). `decode` turns the scores into pitch
and periodicity, by Viterbi (the CUDA kernel of `ops/viterbi.py` on the
card) or per-frame argmax, and refines each decoded bin to sub-bin
precision. `from_audio` adds the interpolation of pitch through
unvoiced frames.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..models.modules import Conv1d, same_padding
from ..ops import grid, viterbi

WINDOW = 512           # correlation window of the NCC front end (samples)
CANDIDATES = 256       # number of log-spaced frequency candidates
TRANSITION_WIDTH = 9.  # triangular transition half-width (bins)
SOFTMAX_SCALE = 40.    # sharpening of NCC values before decoding
FRAME_SIZE = 1024      # samples per analysis frame of the CNN


def candidate_frequencies(fmin, fmax, num=CANDIDATES):
    """Log-spaced candidate frequencies in Hz, float32"""
    return np.exp(
        np.linspace(np.log(fmin), np.log(fmax), num)).astype(np.float32)


class PitchCNN(nn.Module):
    """FCNF0-style framewise pitch-posterior CNN

    The JAX model's Flax defaults, written out: every conv pads 'SAME'
    (asymmetric for these even kernels, also when strided), LayerNorm
    epsilon is 1e-6, and the final Dense reads the (T', C) activations
    flattened time-major.
    """

    def __init__(
        self,
        channels=(128, 32, 32, 64, 128, 256),
        kernel_sizes=(32, 16, 8, 8, 8, 4),
        strides=(4, 2, 2, 1, 1, 1),
        num_bins=CANDIDATES
    ):
        super().__init__()
        self.convs = nn.ModuleList()
        length, previous = FRAME_SIZE, 1
        for features, kernel, stride in zip(channels, kernel_sizes, strides):
            self.convs.append(Conv1d(previous, features, kernel, stride=stride))
            previous = features
            length = -(-length // stride)
        self.norms = nn.ModuleList(
            nn.LayerNorm(features, eps=1e-6) for features in channels)
        self.output = nn.Linear(length * previous, num_bins)
        # Periodicity cutoff calibrated when the weights were trained (the
        # JAX checkpoint's 'voicing_threshold'); None uses the config's
        self.voicing_threshold = None

    def forward(self, frames):
        """frames (B, FRAME_SIZE) → logits (B, num_bins)"""
        x = frames.float()[..., None]
        for conv, norm in zip(self.convs, self.norms):
            left, right = same_padding(
                x.shape[1], conv.weight.shape[-1], conv.stride)
            x = F.relu(norm(conv(F.pad(x, (0, 0, left, right)))))
        return self.output(x.reshape(x.shape[0], -1))


def _frames(samples, hopsize, size):
    """Frames (frames, size) centered at (i + 0.5) * hopsize, zero-padded"""
    num_frames = samples.shape[-1] // hopsize
    centers = (np.arange(num_frames) + 0.5) * hopsize
    starts = np.round(centers - size / 2).astype(np.int64)
    pad_left = max(0, -int(starts.min()))
    pad_right = max(0, int(starts.max()) + size - samples.shape[-1])
    padded = F.pad(samples, (pad_left, pad_right))
    index = (starts + pad_left)[:, None] + np.arange(size)[None]
    return padded[torch.from_numpy(index).to(padded.device)]


def cnn_posteriorgram(model, audio, hopsize):
    """Per-frame CNN logits (frames, CANDIDATES) of audio (1, T)

    Frames are centered at (i + 0.5) * hopsize and normalized to zero
    mean and unit (population) standard deviation.
    """
    frames = _frames(audio[0], hopsize, FRAME_SIZE)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames / torch.clamp(
        frames.std(dim=-1, unbiased=False, keepdim=True), min=1e-6)
    return model(frames)


def ncc(audio, sample_rate, hopsize, frequencies):
    """Normalized cross-correlation of audio (1, T) at candidate frequencies

    Arguments
        frequencies: ascending float32 numpy table in Hz

    Returns
        (frames, len(frequencies)) correlations in [-1, 1]: the first
        WINDOW samples of each frame against the frame shifted by each
        candidate's period, linearly interpolated between integer lags
    """
    max_lag = int(np.ceil(sample_rate / frequencies[0])) + 1
    context = WINDOW + max_lag
    frames = _frames(audio[0], hopsize, context)
    frames = frames - frames.mean(dim=-1, keepdim=True)

    # r[tau] = sum_{n < WINDOW} x[n] x[n + tau], by FFT
    n_fft = int(2 ** np.ceil(np.log2(context + WINDOW)))
    correlation = torch.fft.irfft(
        torch.conj(torch.fft.rfft(frames[:, :WINDOW], n=n_fft)) *
        torch.fft.rfft(frames, n=n_fft),
        n=n_fft)[:, :max_lag + 1]

    # e[tau] = sum_{n < WINDOW} x[n + tau]^2, by a running sum
    cumsum = torch.cumsum(F.pad(frames * frames, (1, 0)), dim=-1)
    energy = cumsum[:, WINDOW:WINDOW + max_lag + 1] - cumsum[:, :max_lag + 1]
    correlation = correlation / torch.sqrt(energy[:, 0:1] * energy + 1e-9)

    lags = sample_rate / frequencies
    lag_left = np.floor(lags).astype(np.int32)
    fraction = torch.from_numpy(
        (lags - lag_left).astype(np.float32)).to(correlation.device)
    left = torch.from_numpy(lag_left.astype(np.int64)).to(correlation.device)
    right = torch.clamp(left + 1, max=max_lag)
    return (correlation[:, left] * (1 - fraction) +
            correlation[:, right] * fraction)


def posteriorgram(audio, sample_rate, hopsize, fmin, fmax):
    """Per-frame NCC (frames, CANDIDATES) over the pitch candidates"""
    return ncc(audio, sample_rate, hopsize, candidate_frequencies(fmin, fmax))


@functools.lru_cache(maxsize=8)
def decode_constants(num_states, width, device):
    """Transition and uniform initial distribution of the pitch decode

    Built once per (states, width, device): on a CUDA device the
    transition comes analysed for the kernel (`viterbi.banded`), so a
    decode builds nothing on the host and copies nothing to the card.
    """
    device = torch.device(device)
    transition = viterbi.triangular_transition(num_states, width).to(device)
    if device.type == 'cuda':
        transition = viterbi.banded(transition)
    initial = torch.full(
        (num_states,), -float(np.log(np.float32(num_states))),
        dtype=torch.float32, device=device)
    return transition, initial


def decode(scores, fmin, fmax, decoder='viterbi', kind='cnn'):
    """Decode front-end scores (frames, N); returns (pitch, periodicity)

    Arguments
        scores: CNN logits ('cnn') or NCC values in [-1, 1] ('dsp')
        decoder: 'viterbi' or 'argmax'
        kind: the front end that made the scores

    Sub-bin refinement takes the posterior-weighted mean log frequency
    over the decoded bin ± 4. Periodicity is the posterior mass at the
    decoded bin for 'cnn' and the clipped correlation there for 'dsp'.
    """
    num_states = scores.shape[-1]
    device = scores.device
    log_freqs = torch.log(torch.from_numpy(
        candidate_frequencies(fmin, fmax, num_states)).to(device))
    # NCC values need sharpening to act like log-probabilities
    logits = SOFTMAX_SCALE * scores if kind == 'dsp' else scores
    if decoder == 'viterbi':
        observation = torch.log_softmax(logits, dim=-1)
        transition, initial = decode_constants(
            num_states, TRANSITION_WIDTH, str(device))
        bins = viterbi.decode(observation, transition, initial).long()
    elif decoder == 'argmax':
        bins = torch.argmax(scores, dim=-1)
    else:
        raise ValueError(f'Pitch decoder {decoder} is not defined')

    offsets = torch.arange(-4, 5, device=device)
    neighbors = torch.clamp(bins[:, None] + offsets, 0, num_states - 1)
    weights = torch.softmax(torch.gather(logits, 1, neighbors), dim=-1)
    pitch = torch.exp(torch.sum(weights * log_freqs[neighbors], dim=-1))

    if kind == 'cnn':
        posterior = torch.softmax(logits, dim=-1)
        periodicity = torch.gather(posterior, 1, bins[:, None])[:, 0]
    else:
        periodicity = torch.clamp(
            torch.gather(scores, 1, bins[:, None])[:, 0], 0., 1.)
    return pitch, periodicity


def estimate(audio, pitch_model, config, decoder, interp_unvoiced_at):
    """Front end → decode → interpolation, on the device of `audio`

    Arguments
        audio: (1, T) float tensor at config.SAMPLE_RATE
        pitch_model: `PitchCNN`; unused by the 'dsp' front end
        interp_unvoiced_at: periodicity at or below which pitch is
            interpolated (in log space) from the voiced neighbours; None
            keeps the decoded pitch

    Returns
        pitch (1, frames) in Hz, periodicity (1, frames)
    """
    kind = 'cnn' if config.PITCH_ESTIMATOR == 'cnn' else 'dsp'
    if kind == 'cnn':
        scores = cnn_posteriorgram(pitch_model, audio, config.HOPSIZE)
    else:
        scores = posteriorgram(
            audio, config.SAMPLE_RATE, config.HOPSIZE, config.FMIN,
            config.FMAX)
    pitch, periodicity = decode(
        scores, config.FMIN, config.FMAX, decoder, kind)
    if interp_unvoiced_at is not None:
        voiced = periodicity > interp_unvoiced_at
        pitch = torch.exp(grid.masked_interp(torch.log(pitch), voiced))
    return pitch[None], periodicity[None]


def from_audio(
    audio,
    pitch_model=None,
    decoder=None,
    interp_unvoiced_at='default',
    config=None,
    device='cuda'
):
    """Estimate pitch and periodicity of audio (1, T) at SAMPLE_RATE

    Arguments
        pitch_model: `PitchCNN` with its weights; needed when
            config.PITCH_ESTIMATOR is 'cnn'
        decoder: 'viterbi' or 'argmax'; None follows
            config.VITERBI_DECODE_PITCH
        interp_unvoiced_at: 'default' takes config.VOICING_THRESHOLD, or
            for the CNN its calibrated `voicing_threshold` where set
        device: where to run; 'cuda' raises on a host without a card

    Returns
        pitch (1, frames) in Hz and periodicity (1, frames) in [0, 1],
        float32 tensors on `device`
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if decoder is None:
        decoder = 'viterbi' if config.VITERBI_DECODE_PITCH else 'argmax'
    if interp_unvoiced_at == 'default':
        interp_unvoiced_at = config.VOICING_THRESHOLD
        if config.PITCH_ESTIMATOR == 'cnn' and \
                pitch_model.voicing_threshold is not None:
            interp_unvoiced_at = pitch_model.voicing_threshold
    audio = torch.as_tensor(np.asarray(audio, np.float32)) \
        if not isinstance(audio, torch.Tensor) else audio.float()
    with torch.no_grad():
        return estimate(
            audio.to(device), pitch_model, config, decoder,
            interp_unvoiced_at)


def from_file(audio_file, pitch_model=None, config=None, device='cuda',
              **kwargs):
    """Pitch and periodicity of a wav file; see `from_audio`"""
    config = config_module.default() if config is None else config
    return from_audio(
        load.audio(audio_file, config), pitch_model, config=config,
        device=device, **kwargs)


def from_file_to_file(audio_file, output_prefix, pitch_model=None,
                      config=None, device='cuda', **kwargs):
    """Pitch and periodicity of a wav file, saved as
    `{prefix}{-viterbi}-pitch.npy` and `{prefix}{-viterbi}-periodicity.npy`
    (the infix when config.VITERBI_DECODE_PITCH is set)"""
    config = config_module.default() if config is None else config
    pitch, periodicity = from_file(
        audio_file, pitch_model, config, device, **kwargs)
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    load.save_array(f'{output_prefix}{viterbi}-pitch.npy', pitch)
    load.save_array(f'{output_prefix}{viterbi}-periodicity.npy', periodicity)
