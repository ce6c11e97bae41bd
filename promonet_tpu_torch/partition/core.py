"""Dataset partitions (counterpart of `promonet_tpu/partition/core.py`)

Train, valid and test splits, with held-out speakers, written to
config.PARTITIONS_DIR / {multispeaker,adaptation} / <dataset>.json (the
JAX package writes them into its own assets). The published datasets
(DAPS, LibriTTS, VCTK) take, in this order:

1. the reference system's shipped partition files, read from
   config.ASSETS_DIR / 'partitions' / 'reference', so metrics compare
   utterance for utterance; shipped stems lack the `-100` loudness
   suffix, which is appended;
2. else a recomputation with the reference's rules: the same
   gender-balanced held-out speakers, test utterances of 4 to 10 s, 10
   per held-out speaker, 64 validation utterances, and for VCTK no
   recording of a test utterance by another microphone elsewhere.

Any other dataset (the synthetic corpus, speaker adaptation) gets a
deterministic generic split. Every shuffle draws from
numpy.random.default_rng(config.RANDOM_SEED), as in the JAX package.
"""
import itertools
import json

import numpy as np

from .. import config as config_module
from ..utils import audio as audio_module

# Test utterance constraints
MIN_TEST_SECONDS = 4.
MAX_TEST_SECONDS = 10.
TEST_UTTERANCES_PER_SPEAKER = 10
VALID_UTTERANCES = 64

# Gender-balanced held-out speakers of the reference system
ADAPTATION_SPEAKERS = {
    'daps': [
        # Female
        '0002', '0007', '0010', '0013', '0019',
        # Male
        '0003', '0005', '0014', '0015', '0017'],
    # LibriTTS speakers are original corpus IDs, mapped through the
    # formatting speaker map (the cache's speakers.json)
    'libritts': [
        # Female
        '40', '669', '4362', '5022', '8123',
        # Male
        '196', '460', '1355', '3664', '7067'],
    'vctk': [
        # Female
        '0013', '0037', '0070', '0082', '0108',
        # Male
        '0016', '0032', '0047', '0073', '0083'],
}


def datasets(names=None, config=None):
    """Partition each dataset of `names` (None: config.DATASETS)"""
    config = config_module.default() if config is None else config
    for name in config.DATASETS if names is None else names:
        dataset(name, config=config)


def dataset(name, adapt=False, config=None):
    """Partition one dataset, write its JSON and return the partition"""
    config = config_module.default() if config is None else config
    if name in ADAPTATION_SPEAKERS:
        partition = published(name, adapt, config)
        if partition is None:
            partition = _dataset_specific(name, adapt, config)
    else:
        partition = _generic(name, config)

    partition = {key: sorted(value) for key, value in partition.items()}
    write(partition, name, adapt, config)
    return partition


def adaptation_partitions(name, num_adapt_utterances=10, config=None):
    """Per-speaker adaptation splits: train-adapt-NN and test-adapt-NN"""
    config = config_module.default() if config is None else config
    cache = config.CACHE_DIR / name
    rng = np.random.default_rng(config.RANDOM_SEED)
    partition = {}
    speakers = sorted(d.name for d in cache.iterdir() if d.is_dir())
    for i, speaker in enumerate(speakers):
        stems = sorted(
            f'{speaker}/{wav.stem}'
            for wav in (cache / speaker).glob('*.wav')
            if _is_original(wav.stem))
        rng.shuffle(stems)
        partition[f'test-adapt-{i:02d}'] = sorted(
            stems[:num_adapt_utterances])
        partition[f'train-adapt-{i:02d}'] = sorted(
            stems[num_adapt_utterances:])
    write(partition, name, True, config)
    return partition


def path(name, adapt, config):
    """The port's partition file of a dataset"""
    return config.PARTITIONS_DIR / (
        'adaptation' if adapt else 'multispeaker') / f'{name}.json'


def write(partition, name, adapt, config, indent=4):
    """Write a partition to the port's file of `name` (`path`)"""
    file = path(name, adapt, config)
    file.parent.mkdir(parents=True, exist_ok=True)
    with open(file, 'w') as handle:
        json.dump(partition, handle, indent=indent)


###############################################################################
# Published datasets
###############################################################################


def published(name, adapt, config):
    """The reference system's shipped partition of a dataset, or None"""
    shipped = (
        config.ASSETS_DIR / 'partitions' / 'reference' /
        ('adaptation' if adapt else 'multispeaker') / f'{name}.json')
    if not shipped.exists():
        return None
    with open(shipped) as handle:
        partition = json.load(handle)
    return {
        key: [f'{stem}-100' for stem in stems]
        for key, stems in partition.items()}


def _dataset_specific(name, adapt, config):
    """The reference's split rules, recomputed from a formatted cache"""
    cache = config.CACHE_DIR / name
    stems = sorted(
        f'{wav.parent.name}/{wav.stem}'
        for wav in cache.glob('*/*.wav')
        if _is_original(wav.stem))
    if not stems:
        raise FileNotFoundError(f'No cached audio for dataset {name}')

    speakers = ADAPTATION_SPEAKERS[name]
    if name == 'libritts':
        with open(cache / 'speakers.json') as handle:
            speaker_map = json.load(handle)
        speakers = [f'{speaker_map[s][0]:04d}' for s in speakers]

    rng = np.random.default_rng(config.RANDOM_SEED)

    # VCTK: another microphone's recording of a test utterance must not
    # land in another split. `data.download` keys correspondence.json by
    # the cache stems, '-100' included; the JAX package appends '-100'
    # once more, so that no stem matches and no take is excluded there.
    correspondence = None
    if name == 'vctk' and (cache / 'correspondence.json').exists():
        with open(cache / 'correspondence.json') as handle:
            correspondence = json.load(handle)

    def meets_length(stem):
        seconds = audio_module.duration(cache / f'{stem}.wav')
        return MIN_TEST_SECONDS <= seconds <= MAX_TEST_SECONDS

    if adapt or name == 'daps':
        # Adaptation partitions over the held-out speakers
        partition = {}
        for i, speaker in enumerate(speakers):
            speaker_stems = [
                stem for stem in stems if stem.split('/')[0] == speaker]
            rng.shuffle(speaker_stems)
            test = [
                stem for stem in speaker_stems if meets_length(stem)
            ][:TEST_UTTERANCES_PER_SPEAKER]
            train = [stem for stem in speaker_stems if stem not in test]
            partition[f'train-adapt-{i:02d}'] = train
            partition[f'test-adapt-{i:02d}'] = test
        if name == 'daps':
            return partition

        # Train and valid over the remaining speakers
        test_stems = set(itertools.chain.from_iterable(partition.values()))
        residual = _exclude(
            [stem for stem in stems if stem not in test_stems],
            test_stems,
            correspondence)
        rng.shuffle(residual)
        valid = [s for s in residual if meets_length(s)][:VALID_UTTERANCES]
        train = [stem for stem in residual if stem not in valid]
        return {'train': train, 'valid': valid, **partition}

    # Multispeaker: 10 test utterances per held-out speaker
    test = []
    for speaker in speakers:
        speaker_stems = [
            stem for stem in stems if stem.split('/')[0] == speaker]
        rng.shuffle(speaker_stems)
        test += [
            stem for stem in speaker_stems if meets_length(stem)
        ][:TEST_UTTERANCES_PER_SPEAKER]
    residual = _exclude(
        [stem for stem in stems if stem not in set(test)],
        set(test),
        correspondence)
    rng.shuffle(residual)
    valid = [s for s in residual if meets_length(s)][:VALID_UTTERANCES]
    train = [stem for stem in residual if stem not in valid]
    return {'train': train, 'valid': valid, 'test': test}


def _exclude(residual, test_stems, correspondence):
    """Residual stems less other microphones' takes of test utterances"""
    if correspondence is None:
        return list(residual)
    test_sources = {
        correspondence[stem][:-1]
        for stem in test_stems if stem in correspondence}
    return [
        stem for stem in residual
        if correspondence.get(stem, ' ')[:-1] not in test_sources]


###############################################################################
# Other datasets
###############################################################################


def _generic(name, config):
    """Deterministic split of an arbitrary dataset, per speaker"""
    cache = config.CACHE_DIR / name
    stems = sorted(
        f'{wav.parent.name}/{wav.stem}'
        for wav in cache.glob('*/*.wav')
        if _is_original(wav.stem))
    if not stems:
        raise FileNotFoundError(f'No cached audio for dataset {name}')

    rng = np.random.default_rng(config.RANDOM_SEED)

    by_speaker = {}
    for stem in stems:
        by_speaker.setdefault(stem.split('/')[0], []).append(stem)

    train, valid, test = [], [], []
    for speaker_stems in by_speaker.values():
        speaker_stems = list(speaker_stems)
        rng.shuffle(speaker_stems)
        n_test = min(
            TEST_UTTERANCES_PER_SPEAKER, max(1, len(speaker_stems) // 5))
        test.extend(speaker_stems[:n_test])
        rest = speaker_stems[n_test:]
        n_valid = max(1, min(len(rest) // 5, VALID_UTTERANCES))
        valid.extend(rest[:n_valid])
        train.extend(rest[n_valid:])

    return {'train': train, 'valid': valid, 'test': test}


def _is_original(stem):
    """True for unaugmented utterances (suffix -100)"""
    return stem.endswith('-100')
