"""Speaker adaptation (counterpart of `promonet_tpu/adapt/core.py`)

A new speaker's recordings are cached as a dataset of their own (one
speaker, '0000'), with quiet audio brought up to a peak of 0.35;
augmented, preprocessed and partitioned as any dataset; then a
generator is trained on them from a base checkpoint for ADAPTATION_STEPS
more steps, in config.RUNS_DIR / <name>.
"""
import numpy as np

from .. import config as config_module
from .. import device as device_module
from .. import partition
from ..data import augment
from ..data.preprocess import core as preprocess_core
from ..train import train
from ..utils import audio as audio_module
from ..utils import cli

# The peak that quiet recordings are brought up to
PEAK_TARGET = 0.35


def normalize_gain(audio, target=PEAK_TARGET):
    """Audio whose peak lies below `target` scaled up to it"""
    peak = np.abs(audio).max()
    if 0 < peak < target:
        return (audio * (target / peak)).astype(np.float32)
    return audio


def speaker(name, files, checkpoint=None, gpu=None, config=None,
            device='cuda'):
    """Adapt a generator to the speaker of `files`; returns the run
    directory

    Arguments
        name: the speaker's dataset name (under config.CACHE_DIR) and run
            name (under config.RUNS_DIR)
        files: the speaker's audio files
        checkpoint: the generator checkpoint to adapt (None trains from
            scratch, as the JAX package does)
        gpu: a GPU index as the command line takes it, overriding
            `device`; -1 is the CPU
        config: a `config.Config`; None reads the environment's
        device: where to preprocess and train
    """
    config = config_module.default() if config is None else config
    if gpu is not None:
        device = cli.device(gpu)
    device = device_module.resolve(device)
    speaker_dir = config.CACHE_DIR / name / '0000'
    speaker_dir.mkdir(parents=True, exist_ok=True)
    for i, file in enumerate(sorted(files)):
        audio, _ = audio_module.load(file, config.SAMPLE_RATE)
        audio_module.save(
            speaker_dir / f'{i:06d}-100.wav', normalize_gain(audio),
            config.SAMPLE_RATE)
    augment.datasets([name], config)
    preprocess_core.datasets([name], config=config, device=device)
    partition.dataset(name, config=config)
    directory = config.RUNS_DIR / name
    train(directory, dataset=name, adapt_from=checkpoint, config=config,
          device=device)
    return directory
