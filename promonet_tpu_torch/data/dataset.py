"""Dataset over the preprocessed feature cache

Counterpart of `promonet_tpu/data/dataset.py`, without its chunked
training path (`random_chunk`, the native wav decoder): the same cache
layout (config.CACHE_DIR / <dataset> / <speaker> / <utterance>-100[-aug]
plus one file per feature), the partition's stems with the augmented
variants of training partitions, the mains-hum stem filter, the speaker
map, and whole utterances from `load_item`. Loudness-augmented stems
reuse the original's loudness, as in the JAX package.
"""
import json

import numpy as np

from .. import config as config_module
from .. import load


class Dataset:
    """The stems of one partition of a dataset

    Arguments
        name: the dataset's directory under config.CACHE_DIR
        partition: a key of its partition file (`load.partition`);
            '*-adapt-*' partitions are read from the adaptation file
        config: a `config.Config`; None reads the environment's
    """

    def __init__(self, name, partition, config=None):
        self.config = config_module.default() if config is None else config
        self.name = name
        self.partition = partition
        self.cache = self.config.CACHE_DIR / name
        self.viterbi = '-viterbi' if self.config.VITERBI_DECODE_PITCH else ''

        adapt = True if '-adapt-' in partition else None
        stems = list(load.partition(name, adapt, self.config)[partition])
        self.stems = []
        for stem in stems:
            self.stems.append(stem)
            if partition.startswith('train'):
                self.stems.extend(self._augmented_stems(stem))

        # Stems whose pitch is mains hum are left out
        self.stems = [stem for stem in self.stems if not self._is_hum(stem)]

        speakers = sorted({stem.split('/')[0] for stem in stems})
        self.speaker_index = {speaker: i for i, speaker in enumerate(speakers)}

    def _augmented_stems(self, stem):
        """The augmented variants of a stem in the ratio files
        (config.AUGMENT_DIR / '<dataset>-{pitch,loudness}.json')"""
        stems = []
        for kind, prefix, enabled in (
            ('pitch', 'p', self.config.AUGMENT_PITCH),
            ('loudness', 'l', self.config.AUGMENT_LOUDNESS)
        ):
            file = self.config.AUGMENT_DIR / f'{self.name}-{kind}.json'
            if not enabled or not file.exists():
                continue
            with open(file) as handle:
                ratios = json.load(handle)
            if stem in ratios:
                stems.append(f'{stem}-{prefix}{ratios[stem]}')
        return stems

    def _is_hum(self, stem):
        """True if the mean log2 pitch is at or below 60 Hz (mains hum)"""
        try:
            pitch = load.array(self.cache / f'{stem}{self.viterbi}-pitch.npy')
        except FileNotFoundError:
            return False
        return float(2 ** np.log2(pitch[~np.isnan(pitch)]).mean()) <= 60.

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, index):
        return self.load_item(index)

    def load_item(self, index):
        """One whole utterance as a dict of numpy arrays and its text

        Keys: text, loudness (n_freq, T), pitch (T,), periodicity (T,), ppg
        (PPG_CHANNELS, T), speakers (an int id, or under ZERO_SHOT the
        stem's x-vector), spectral_balance_ratios, loudness_ratios,
        spectrograms (n_freq, T), stems and audio (1, samples).
        """
        stem = self.stems[index]
        cache = self.cache
        pitch = load.array(cache / f'{stem}{self.viterbi}-pitch.npy')
        periodicity = load.array(
            cache / f'{stem}{self.viterbi}-periodicity.npy')
        base, ratio_pitch, ratio_loudness = self._parse_ratios(stem)
        loudness_stem = base if ratio_loudness != 1. else stem
        frames = pitch.shape[-1]
        ppg = load.array(cache / f'{stem}-ppg.npy')
        if ppg.shape[-1] != frames:
            ppg = load.ppg(
                cache / f'{stem}-ppg.npy', frames, self.config, 'cpu').numpy()

        text_file = cache / f'{base.split("-")[0]}.txt'
        if not text_file.exists():
            text_file = cache / f'{base}.txt'
        text = load.text(text_file) if text_file.exists() else ''

        speaker_dir = stem.split('/')[0]
        if self.config.ZERO_SHOT:
            speaker = load.array(cache / f'{stem}-speaker.npy')
        else:
            speaker = np.asarray(
                self.speaker_index.get(speaker_dir, 0), np.int32)

        return {
            'text': text,
            'loudness': np.asarray(
                load.array(cache / f'{loudness_stem}-loudness.npy'),
                np.float32),
            'pitch': np.asarray(pitch, np.float32).reshape(-1),
            'periodicity': np.asarray(periodicity, np.float32).reshape(-1),
            'ppg': np.asarray(ppg, np.float32),
            'speakers': speaker,
            'spectral_balance_ratios': np.asarray(ratio_pitch, np.float32),
            'loudness_ratios': np.asarray(ratio_loudness, np.float32),
            'spectrograms': np.asarray(
                load.array(cache / f'{stem}-spectrogram.npy'), np.float32),
            'stems': stem,
            'audio': np.asarray(
                load.audio(cache / f'{stem}.wav', self.config), np.float32)}

    @staticmethod
    def _parse_ratios(stem):
        """(base stem, pitch ratio, loudness ratio) of an augmented stem

        Suffixes: -p<int> (pitch ratio x 100) and -l<int> (loudness ratio
        x 100).
        """
        parts = stem.split('-')
        base_parts = [parts[0]]
        pitch_ratio, loudness_ratio = 1., 1.
        for part in parts[1:]:
            if part.startswith('p') and part[1:].isdigit():
                pitch_ratio = int(part[1:]) / 100.
            elif part.startswith('l') and part[1:].isdigit():
                loudness_ratio = int(part[1:]) / 100.
            else:
                base_parts.append(part)
        return '-'.join(base_parts), pitch_ratio, loudness_ratio
