"""Speech transcription, for the word error rate of the evaluation

Counterpart of `promonet_tpu/preprocess/text.py`. The JAX package
transcribes with a locally cached Whisper model where there is one, and
otherwise decodes phonemes with the trained PPG encoder. Whisper is not
in the repository, so the port has the phoneme decoder only: frame
argmax of the PPG encoder's posteriors, runs of one phoneme collapsed,
silence and one-frame runs dropped. On the formant-synthesis corpus the
transcripts are phone strings (`data.synthetic`), so the word error rate
over phone tokens is a phoneme error rate. Without a PPG checkpoint
(`available`) nothing can transcribe, and `from_audio` raises.
"""
import re

import numpy as np
import torch

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..utils import audio as audio_module
from ..utils import checkpoint as checkpoint_module
from . import spectrogram as spectrogram_module
from .ppg import PHONEMES, PHONEME_TO_INDEX_MAPPING, SILENCE


def available(config=None):
    """Whether a transcriber can run: a `ppg-*.pt` checkpoint resolves in
    config.CHECKPOINTS_DIR"""
    config = config_module.default() if config is None else config
    return checkpoint_module.latest_path(
        config.CHECKPOINTS_DIR, 'ppg-*') is not None


def from_audio(
    audio, ppg_model=None, sample_rate=None, config=None, device='cuda'
):
    """Transcribe speech audio (1, T) as a phone string

    ppg_model None takes the PPG checkpoint of config.CHECKPOINTS_DIR;
    without one, RuntimeError (the JAX package raises there too).
    """
    config = config_module.default() if config is None else config
    if ppg_model is None:
        if not available(config):
            raise RuntimeError(
                f'no transcriber: no ppg-*.pt checkpoint in '
                f'{config.CHECKPOINTS_DIR}, and Whisper is not in the '
                'repository')
        ppg_model = load.ppg_model(config=config, device=device)
    return phonemes_from_audio(audio, ppg_model, sample_rate, config, device)


def phonemes_from_audio(
    audio, ppg_model, sample_rate=None, config=None, device='cuda'
):
    """Phone string of audio (1, T) by decoding the PPG encoder's frames

    The unpadded audio's log-mels go through `ppg_model` on `device`; the
    frame argmax of the posteriors is taken on the host, runs of one
    phoneme collapse to one token, and silence and runs of one frame (a
    transition, not a spoken phone) are dropped.
    """
    config = config_module.default() if config is None else config
    device = device_module.resolve(device)
    if sample_rate is not None and sample_rate != config.SAMPLE_RATE:
        audio = audio_module.resample(
            _to_numpy(audio), sample_rate, config.SAMPLE_RATE)
    audio = torch.as_tensor(_to_numpy(audio) if not isinstance(
        audio, torch.Tensor) else audio).to(device, torch.float32)
    with torch.no_grad():
        mels = spectrogram_module.linear_to_mel(
            spectrogram_module.from_audio(audio, config), config)
        posteriors = torch.exp(ppg_model(mels.transpose(0, 1)[None])[0])
    ids = posteriors.cpu().numpy().argmax(axis=1)

    silence = PHONEME_TO_INDEX_MAPPING[SILENCE]
    phones, run_id, run_length = [], None, 0
    for i in np.concatenate([ids, [-1]]):
        if i == run_id:
            run_length += 1
            continue
        if run_id is not None and run_id != silence and run_length >= 2:
            phones.append(PHONEMES[run_id])
        run_id, run_length = i, 1
    return ' '.join(phones)


def from_file(audio_file, ppg_model=None, config=None, device='cuda'):
    """Transcribe a wav file"""
    config = config_module.default() if config is None else config
    return from_audio(
        load.audio(audio_file, config), ppg_model, config=config,
        device=device)


def from_file_to_file(
    audio_file, output_file, ppg_model=None, config=None, device='cuda'
):
    """Transcribe a wav file into a UTF-8 text file"""
    with open(output_file, 'w', encoding='utf-8') as file:
        file.write(from_file(audio_file, ppg_model, config, device))


def from_files_to_files(
    audio_files, output_files, ppg_model=None, config=None, device='cuda'
):
    """Transcribe several wav files, one after another"""
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, ppg_model, config, device)


def normalize(text):
    """Text as the word error rate compares it: lowercase, punctuation
    but apostrophes as spaces, whitespace collapsed"""
    text = text.lower()
    text = re.sub(r"[^\w\s']", ' ', text)
    text = re.sub(r'\s+', ' ', text)
    return text.strip()


def _to_numpy(audio):
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    return np.asarray(audio, np.float32)
