"""python -m promonet_tpu_torch.preprocess

Counterpart of `python -m promonet_tpu.preprocess`, with its arguments
and file names:

    python -m promonet_tpu_torch.preprocess --files a.wav b.wav \
        [--output_prefixes a b] [--features loudness pitch periodicity ppg] \
        [--config file.py ...] [--gpu N]

The pitch CNN, the PPG encoder and the speaker encoder are read from
config.CHECKPOINTS_DIR (`load`); where one is missing, the JAX package's
fallback is taken and named on stderr. `--gpu -1` runs on the CPU.
"""
from pathlib import Path

from .. import load
from ..utils.cli import ArgumentParser
from .core import from_files_to_files


def parse_args():
    parser = ArgumentParser(description='Preprocess')
    parser.add_argument(
        '--files', type=Path, nargs='+', required=True,
        help='Audio files to preprocess')
    parser.add_argument(
        '--output_prefixes', type=Path, nargs='+',
        help='Files to save features, minus extension')
    parser.add_argument(
        '--features', nargs='+',
        default=['loudness', 'pitch', 'periodicity', 'ppg'],
        help='The features to preprocess')
    return parser.parse_args()


def main(files, output_prefixes, features, config, device):
    """Preprocess `files` with the models the features need"""
    pitch_model = ppg_model = speaker_model = None
    if ('pitch' in features or 'periodicity' in features) and \
            config.PITCH_ESTIMATOR == 'cnn':
        pitch_model = load.pitch_model(config=config, device=device)
    if 'ppg' in features:
        ppg_model = load.ppg_model(config=config, device=device)
    if 'speaker' in features:
        speaker_model = load.speaker_encoder(config=config, device=device)
    from_files_to_files(
        files, pitch_model, ppg_model, output_prefixes, features,
        config=config, device=device, speaker_model=speaker_model)


if __name__ == '__main__':
    main(**vars(parse_args()))
