"""Phonetic posteriorgrams (counterpart of `preprocess/ppg.py`)

`PPGEncoder` is the forward pass of the JAX package's Flax encoder over
log-mels, with Flax's defaults written out: 'SAME' padding, LayerNorm
epsilon 1e-6, and the tanh approximation of GELU. `train` trains it on
the formant corpus's frame-aligned phonemes.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..models import init
from ..models.modules import Conv1d
from ..utils import checkpoint
from . import spectrogram, training

# 39 CMUdict phonemes + silence
PHONEMES = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'ch', 'd', 'dh',
    'eh', 'er', 'ey', 'f', 'g', 'hh', 'ih', 'iy', 'jh', 'k',
    'l', 'm', 'n', 'ng', 'ow', 'oy', 'p', 'r', 's', 'sh',
    't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', '<silence>']

PHONEME_TO_INDEX_MAPPING = {p: i for i, p in enumerate(PHONEMES)}

SILENCE = '<silence>'

# Voiced phonemes (vowels, semivowels, nasals, voiced obstruents); the
# PPG-aware time stretch may exempt all other frames
VOICED = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'd', 'dh', 'eh', 'er', 'ey',
    'g', 'ih', 'iy', 'jh', 'l', 'm', 'n', 'ng', 'ow', 'oy', 'r', 'uh',
    'uw', 'v', 'w', 'y', 'z', 'zh']


class PPGEncoder(nn.Module):
    """Frame-rate phoneme classifier over log-mels"""

    def __init__(
        self, num_mels=80, channels=256, num_layers=6, num_phonemes=40,
        kernel_size=5
    ):
        super().__init__()
        self.channels = channels
        padding = (kernel_size // 2, kernel_size - 1 - kernel_size // 2)
        self.convs = nn.ModuleList(
            Conv1d(num_mels if i == 0 else channels, channels, kernel_size,
                   padding=padding)
            for i in range(num_layers))
        self.norms = nn.ModuleList(
            nn.LayerNorm(channels, eps=1e-6) for _ in range(num_layers))
        self.output = nn.Linear(channels, num_phonemes)

    def forward(self, mels):
        """mels (B, T, NUM_MELS) → log-posteriors (B, T, num_phonemes)"""
        x = mels.to(self.output.weight.dtype)
        for conv, norm in zip(self.convs, self.norms):
            y = F.gelu(norm(conv(x, x.dtype)), approximate='tanh')
            x = y if x.shape[-1] != self.channels else x + y
        return torch.log_softmax(self.output(x), dim=-1)


def from_audio(audio, model=None, config=None, device='cuda'):
    """PPG (PPG_CHANNELS, frames) of audio (1, T), a float32 tensor on
    `device`; model None takes `load.ppg_model` of config"""
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if model is None:
        model = load.ppg_model(config=config, device=device)
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    with torch.no_grad():
        mels = spectrogram.from_audio(
            audio.to(device).float(), config, mels=True)
        return torch.exp(model(mels.T[None])[0].T)


def from_file(audio_file, model=None, config=None, device='cuda'):
    """PPG of a wav file; see `from_audio`"""
    config = config_module.default() if config is None else config
    return from_audio(load.audio(audio_file, config), model, config, device)


def from_file_to_file(audio_file, output_file, model=None, config=None,
                      device='cuda'):
    """PPG of a wav file, saved to `output_file`"""
    load.save_array(
        output_file, from_file(audio_file, model, config, device))


def from_files_to_files(audio_files, output_files, model=None, config=None,
                        device='cuda'):
    """PPGs of several wav files, in turn"""
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, model, config, device)


###############################################################################
# Training
###############################################################################


def training_examples(dataset, window, config, device):
    """The window bank of `train`

    Each utterance with an alignment (`-phonemes.npy`) under
    config.CACHE_DIR / dataset, in sorted order: its log-mels (computed on
    `device`) and labels over its frames, zero-padded to whole windows and
    cut into windows, with a mask of the frames that are not padding.

    Returns mels (N, window, NUM_MELS) float32, labels (N, window) int32
    and masks (N, window) bool, as numpy.
    """
    cache = config.CACHE_DIR / dataset
    alignments = sorted(cache.glob('*/*-phonemes.npy'))
    if not alignments:
        raise FileNotFoundError(
            f'No phoneme alignments under {cache}; generate the corpus with '
            'promonet_tpu_torch.data.synthetic.create(...)')
    examples, targets, masks = [], [], []
    for alignment in alignments:
        stem = str(alignment)[:-len('-phonemes.npy')]
        labels = np.load(alignment)
        audio = load.audio(f'{stem}.wav', config)
        frames = min(labels.shape[0], audio.shape[-1] // config.HOPSIZE)
        mels = training.window_mels(audio, frames, window, config, device)
        padded_frames = len(mels)
        labels = np.pad(labels[:frames], (0, padded_frames - frames))
        mask = np.arange(padded_frames) < frames
        for start in range(0, padded_frames, window):
            examples.append(mels[start:start + window])
            targets.append(labels[start:start + window])
            masks.append(mask[start:start + window])
    return (np.stack(examples).astype(np.float32),
            np.stack(targets).astype(np.int32), np.stack(masks))


def training_loss(model, mels, labels, mask):
    """Negative log-likelihood of the labels (B, T), averaged over the
    frames that `mask` (B, T) keeps"""
    nll = -torch.gather(model(mels), -1, labels[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.)


def accuracy(model, mels, labels, mask):
    """Share of the frames that `mask` keeps whose argmax is the label"""
    with torch.no_grad():
        correct = (torch.argmax(model(mels), dim=-1) == labels) * mask
        return float(correct.sum() / torch.clamp(mask.sum(), min=1.))


def train(
    dataset='synthetic',
    steps=3000,
    batch_size=32,
    window=256,
    learning_rate=1e-3,
    output=None,
    config=None,
    device='cuda',
    callback=None
):
    """Train the PPG encoder on the formant corpus's phoneme alignments

    `training_loss` under AdamW (weight decay 1e-4) and a cosine
    schedule, weights seeded from RANDOM_SEED (`models.init`). The window
    bank (`training_examples`) is held on `device` and each batch
    gathered there; the held-out split (one window in twenty, at least
    two) and the batch indices come from `numpy.random.default_rng(
    RANDOM_SEED)`, as in the JAX package.

    Arguments
        output: the checkpoint's directory (None: config.CHECKPOINTS_DIR)
        device: where to train; 'cuda' raises on a host without a card
        callback: called as callback(step, loss) after each step, the
            loss a tensor on `device`

    Returns the held-out frame accuracy; writes `ppg-<steps>.pt` with
    'accuracy', which `load.ppg_model` reads.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    examples, targets, masks = training_examples(
        dataset, window, config, device)

    rng = np.random.default_rng(config.RANDOM_SEED)
    order = rng.permutation(len(examples))
    num_valid = max(2, len(order) // 20)
    valid_index, train_index = order[:num_valid], order[num_valid:]

    model = init.seeded(
        PPGEncoder(config.NUM_MELS, num_phonemes=config.PPG_CHANNELS),
        config.RANDOM_SEED).to(device).train()
    optimizer, schedule = training.adamw_cosine(
        model.parameters(), learning_rate, steps)
    bank = (
        torch.from_numpy(examples).to(device),
        torch.from_numpy(targets.astype(np.int64)).to(device),
        torch.from_numpy(masks.astype(np.float32)).to(device))
    valid = [tensor[torch.from_numpy(valid_index).to(device)]
             for tensor in bank]

    batches = training.batches(rng, train_index, batch_size, steps, device)
    for step, batch in enumerate(batches):
        loss = training.update(
            training_loss(model, *(tensor[batch] for tensor in bank)),
            optimizer, schedule)
        if callback is not None:
            callback(step, loss)
        if step % 500 == 0:
            print(f'ppg train step {step}: loss {float(loss):.3f}, '
                  f'valid acc {accuracy(model, *valid):.3f}', flush=True)

    model.eval()
    result = accuracy(model, *valid)
    checkpoint.save(
        training.checkpoint_file('ppg', steps, output, config),
        model.state_dict(), step=steps, accuracy=result)
    return result
