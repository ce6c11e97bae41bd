"""Pitch and periodicity estimation

Counterpart of `promonet_tpu/preprocess/pitch.py`. Two front ends score
each frame over 256 log-spaced candidate frequencies: the learned
`PitchCNN` on 1024-sample frames ('cnn', `cnn_posteriorgram`) and the
normalized cross-correlation ('dsp', `posteriorgram`, shared with the
harmonics analysis through `ncc`). `decode` turns the scores into pitch
and periodicity, by Viterbi (the CUDA kernel of `ops/viterbi.py` on the
card) or per-frame argmax, and refines each decoded bin to sub-bin
precision. `from_audio` adds the interpolation of pitch through
unvoiced frames. `train` trains the CNN on the formant corpus's true
pitch and domain-randomised tones (`_tone_frames`).
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..models import init
from ..models.modules import Conv1d, same_padding
from ..ops import grid, viterbi
from ..utils import checkpoint
from . import training

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
        # In the weights' dtype: float32, or float64 for a check
        x = frames.to(self.output.weight.dtype)[..., None]
        for conv, norm in zip(self.convs, self.norms):
            left, right = same_padding(
                x.shape[1], conv.weight.shape[-1], conv.stride)
            x = F.relu(norm(conv(F.pad(x, (0, 0, left, right)), x.dtype)))
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
    They are built outside inference mode whatever the caller's mode: a
    first decode under `torch.inference_mode` (a training run's
    validation) would otherwise cache inference tensors for every later
    caller.
    """
    device = torch.device(device)
    with torch.inference_mode(False):
        transition = viterbi.triangular_transition(num_states, width).to(
            device)
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


###############################################################################
# Training
###############################################################################


def _tone_frames(rng, count, frame_size, hopsize, config):
    """`count` frames of domain-randomised harmonic tones, all voiced

    Trajectories (constant, glide, vibrato, random walk) over the whole
    [FMIN, FMAX] candidate range, random harmonic rolloffs and phases,
    amplitude modulation and a noise floor at 10-40 dB SNR: the speech
    corpus alone leaves the CNN to fail on signals outside its register.
    Every draw is the JAX package's, from `rng` in its order.

    Returns frames (count, frame_size) float32, their bins (count,) int32
    and voicing (count,) bool.
    """
    sample_rate = config.SAMPLE_RATE
    log_fmin = np.log2(config.FMIN * 1.05)
    log_fmax = np.log2(config.FMAX * 0.95)
    log_freqs = np.log(candidate_frequencies(config.FMIN, config.FMAX))

    frames_list, bins_list = [], []
    collected = 0
    while collected < count:
        num_frames = int(rng.integers(32, 128))
        samples = num_frames * hopsize
        t = np.arange(samples) / sample_rate

        # F0 trajectory in log2-Hz
        kind = rng.integers(4)
        lo, hi = sorted(rng.uniform(log_fmin, log_fmax, 2))
        if kind == 0:                                   # constant
            logf = np.full(samples, rng.uniform(log_fmin, log_fmax))
        elif kind == 1:                                 # glide
            logf = np.linspace(lo, hi, samples)
            if rng.random() < 0.5:
                logf = logf[::-1].copy()
        elif kind == 2:                                 # vibrato
            center = rng.uniform(log_fmin + 0.1, log_fmax - 0.1)
            rate = rng.uniform(0.5, 7.)
            depth = rng.uniform(0.01, 0.1)
            logf = center + depth * np.sin(
                2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
        else:                                           # random walk
            walk = np.cumsum(rng.standard_normal(num_frames)) * 0.02
            walk = np.clip(
                walk - walk.mean() + rng.uniform(lo, hi), log_fmin, log_fmax)
            logf = np.repeat(walk, hopsize)
        f0 = 2. ** np.clip(logf, log_fmin, log_fmax)

        # Harmonic stack with random rolloff and phases
        num_harmonics = int(rng.integers(1, 9))
        rolloff = rng.uniform(0.3, 0.95)
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        audio = np.zeros(samples)
        nyquist = sample_rate / 2
        for k in range(1, num_harmonics + 1):
            amplitude = rolloff ** (k - 1)
            audio += amplitude * np.sin(
                k * phase + rng.uniform(0, 2 * np.pi)) * ((k * f0) < nyquist)

        # Amplitude modulation and a noise floor
        modulation_rate = rng.uniform(0.5, 6.)
        audio *= 0.55 + 0.45 * np.sin(
            2 * np.pi * modulation_rate * t + rng.uniform(0, 2 * np.pi))
        peak = np.abs(audio).max() + 1e-9
        audio = audio / peak * rng.uniform(0.1, 0.9)
        snr_db = rng.uniform(10., 40.)
        noise = rng.standard_normal(samples)
        noise *= np.sqrt((audio ** 2).mean() / 10 ** (snr_db / 10))
        audio = (audio + noise).astype(np.float32)

        frames_list.append(_frames(
            torch.from_numpy(audio), hopsize, frame_size).numpy())
        frame_f0 = f0.reshape(num_frames, hopsize).mean(axis=-1)
        bins_list.append(_nearest_bins(frame_f0, log_freqs))
        collected += num_frames

    frames = np.concatenate(frames_list)[:count]
    bins = np.concatenate(bins_list)[:count]
    return frames, bins, np.ones(len(frames), bool)


def _nearest_bins(hz, log_freqs):
    """int32 index of the candidate nearest each frequency in log space"""
    return np.abs(
        np.log(hz)[:, None] - log_freqs[None]).argmin(axis=-1).astype(np.int32)


def training_examples(rng, dataset, max_frames, tone_fraction, config):
    """The frame bank of `train`, drawn from `rng` in the JAX order

    Speech: every voiced frame of each utterance with ground truth
    (`-truepitch.npy`, `-voiced.npy`) under config.CACHE_DIR / dataset, in
    sorted order, and each unvoiced one with probability 1/4, until
    `max_frames` are kept; then tones (`_tone_frames`), tone_fraction of
    the whole. Each frame normalised to zero mean and unit standard
    deviation.

    Returns frames (N, FRAME_SIZE) float32, bins (N,) int32, voiced (N,)
    and speech (N,) bool.
    """
    cache = config.CACHE_DIR / dataset
    truths = sorted(cache.glob('*/*-truepitch.npy'))
    if not truths:
        raise FileNotFoundError(
            f'No F0 ground truth under {cache}; generate the corpus with '
            'promonet_tpu_torch.data.synthetic.create(...)')
    hopsize = config.HOPSIZE
    log_freqs = np.log(candidate_frequencies(config.FMIN, config.FMAX))

    frames_list, bins_list, voiced_list, speech_list = [], [], [], []
    collected = 0
    for truth in truths:
        stem = str(truth)[:-len('-truepitch.npy')]
        f0 = np.load(truth)
        voiced = np.load(f'{stem}-voiced.npy')
        audio = load.audio(f'{stem}.wav', config)[0]
        num_frames = min(len(f0), audio.shape[-1] // hopsize)
        frames = _frames(
            torch.from_numpy(audio), hopsize, FRAME_SIZE)[:num_frames].numpy()

        # Every voiced frame, and a sample of unvoiced ones for the
        # voicing calibration
        keep = voiced[:num_frames] | (rng.random(num_frames) < 0.25)
        frames_list.append(frames[keep])
        bins_list.append(_nearest_bins(f0[:num_frames][keep], log_freqs))
        voiced_list.append(voiced[:num_frames][keep])
        speech_list.append(np.ones(int(keep.sum()), bool))
        collected += int(keep.sum())
        if collected >= max_frames:
            break

    if tone_fraction > 0:
        count = int(collected * tone_fraction / (1 - tone_fraction))
        tone_frames, tone_bins, tone_voiced = _tone_frames(
            rng, count, FRAME_SIZE, hopsize, config)
        frames_list.append(tone_frames)
        bins_list.append(tone_bins)
        voiced_list.append(tone_voiced)
        speech_list.append(np.zeros(len(tone_voiced), bool))

    frames = np.concatenate(frames_list)
    frames = frames - frames.mean(axis=-1, keepdims=True)
    frames = frames / np.maximum(frames.std(axis=-1, keepdims=True), 1e-6)
    return (frames, np.concatenate(bins_list), np.concatenate(voiced_list),
            np.concatenate(speech_list))


def training_loss(model, frames, bins):
    """Cross-entropy of the bins of frames (B, FRAME_SIZE), float32"""
    return F.cross_entropy(model(frames), bins)


def train(
    dataset='synthetic',
    steps=4000,
    batch_size=128,
    learning_rate=2e-4,
    max_frames=120000,
    tone_fraction=0.4,
    output=None,
    config=None,
    device='cuda',
    callback=None
):
    """Train the pitch CNN on the formant corpus's true pitch

    Cross-entropy over the candidate bins on voiced frames, AdamW
    (weight decay 1e-4) under a cosine schedule, weights seeded from
    RANDOM_SEED (`models.init`). The frame bank (`training_examples`) is
    held on `device` in bf16, as the JAX package holds it, and each batch
    gathered there and cast to float32. One frame in twenty is held out:
    on it the median error in cents of the argmax bin over voiced frames,
    and a voicing threshold on the posterior mass at that bin
    (`held_out_figures`).

    Arguments
        dataset: the corpus's directory under config.CACHE_DIR
        output: the checkpoint's directory (None: config.CHECKPOINTS_DIR)
        device: where to train; 'cuda' raises on a host without a card
        callback: called as callback(step, loss) after each step, the
            loss a tensor on `device`

    Returns (median cents, voicing accuracy); writes `pitch-<steps>.pt`
    with 'voicing_threshold', 'median_cents' and 'voicing_accuracy',
    which `load.pitch_model` reads.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    rng = np.random.default_rng(config.RANDOM_SEED)
    frames, bins, voiced, speech = training_examples(
        rng, dataset, max_frames, tone_fraction, config)

    order = rng.permutation(len(frames))
    num_valid = max(1, len(order) // 20)
    valid_index, train_index = order[:num_valid], order[num_valid:]
    train_voiced = train_index[voiced[train_index]]

    model = init.seeded(PitchCNN(), config.RANDOM_SEED).to(device).train()
    optimizer, schedule = training.adamw_cosine(
        model.parameters(), learning_rate, steps)
    # One upload; batches are gathered on the device
    bank = torch.from_numpy(frames).to(torch.bfloat16).to(device)
    bank_bins = torch.from_numpy(bins.astype(np.int64)).to(device)

    batches = training.batches(rng, train_voiced, batch_size, steps, device)
    for step, batch in enumerate(batches):
        loss = training.update(
            training_loss(model, bank[batch].float(), bank_bins[batch]),
            optimizer, schedule)
        if callback is not None:
            callback(step, loss)
        if step % 1000 == 0:
            print(f'pitch train step {step}: loss {float(loss):.3f}',
                  flush=True)

    model.eval()
    with torch.no_grad():
        logits = model(bank[torch.from_numpy(
            valid_index.astype(np.int64)).to(device)].float())
        best = torch.argmax(logits, dim=-1)
        confidence = torch.gather(
            torch.softmax(logits, dim=-1), 1, best[:, None])[:, 0]
    median_cents, threshold, score = held_out_figures(
        best.cpu().numpy(), confidence.cpu().numpy(), bins[valid_index],
        voiced[valid_index], speech[valid_index], config)

    checkpoint.save(
        training.checkpoint_file('pitch', steps, output, config),
        model.state_dict(), step=steps,
        voicing_threshold=threshold, median_cents=median_cents,
        voicing_accuracy=score)
    return median_cents, score


def held_out_figures(decoded, confidence, bins, voiced, speech, config):
    """`train`'s figures on the held-out frames

    Arguments
        decoded: (N,) argmax bins; confidence: (N,) posterior mass there
        bins, voiced, speech: the frames' true bins, voicing and whether
            they are speech (not tones)

    Returns the median error in cents of the voiced frames' bins, and the
    voicing threshold on the confidence with its balanced accuracy: the
    best over 97 quantiles of the speech frames' confidence (the tones'
    extreme SNRs would move the operating point away from the signals
    this runs on).
    """
    log_freqs = np.log(candidate_frequencies(config.FMIN, config.FMAX))
    cents = np.abs(
        log_freqs[decoded[voiced]] - log_freqs[bins[voiced]]
    ) * 1200 / np.log(2)
    median_cents = float(np.median(cents)) if voiced.any() else float('nan')

    if speech.any():
        confidence, voiced = confidence[speech], voiced[speech]
    candidates = np.quantile(confidence, np.linspace(0.02, 0.98, 97))
    best_threshold, best_score = 0.5, -1.
    for threshold in candidates:
        predicted = confidence > threshold
        tpr = (predicted & voiced).sum() / max(voiced.sum(), 1)
        tnr = (~predicted & ~voiced).sum() / max((~voiced).sum(), 1)
        score = 0.5 * (tpr + tnr)
        if score > best_score:
            best_score, best_threshold = score, float(threshold)
    return median_cents, best_threshold, float(best_score)
