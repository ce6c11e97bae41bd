"""Dataset over the preprocessed feature cache

Counterpart of `promonet_tpu/data/dataset.py`: the same cache layout
(config.CACHE_DIR / <dataset> / <speaker> / <utterance>-100[-aug] plus one
file per feature), the partition's stems with the augmented variants of
training partitions, the mains-hum stem filter, the speaker map, whole
utterances from `load_item`, and the training path: `load_item(index,
chunk_rng)` crops CHUNK_SIZE samples and their frames at a start drawn
from `chunk_rng`, reading only that window of the features (memory-mapped)
and of the wav (the native decoder, `data.native`, or its plain version),
and reflect-pads an utterance shorter than a chunk (`random_chunk`).
Loudness-augmented stems reuse the original's loudness, as in the JAX
package.
"""
import json

import numpy as np

from .. import config as config_module
from .. import load
from . import native as native_module


def _windowed_load(file, window):
    """The trailing-axis window of an .npy, read memory-mapped"""
    return np.asarray(np.load(file, mmap_mode='r')[..., window], np.float32)


def _frames_of(file):
    """Trailing-axis length of an .npy, from its header (the data is
    mapped, not read)"""
    return np.load(file, mmap_mode='r').shape[-1]


class Dataset:
    """The stems of one partition of a dataset

    Arguments
        name: the dataset's directory under config.CACHE_DIR
        partition: a key of its partition file (`load.partition`);
            '*-adapt-*' partitions are read from the adaptation file
        config: a `config.Config`; None reads the environment's
        native: crop training audio with the native decoder
            (`data.native.wav_chunk`, built at first use) instead of its
            plain version
    """

    def __init__(self, name, partition, config=None, native=False):
        self.config = config_module.default() if config is None else config
        self.native = native
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
        (`ratio_file`)"""
        stems = []
        for kind, prefix, enabled in (
            ('pitch', 'p', self.config.AUGMENT_PITCH),
            ('loudness', 'l', self.config.AUGMENT_LOUDNESS)
        ):
            file = ratio_file(self.name, kind, self.config)
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

    def load_item(self, index, chunk_rng=None):
        """One utterance as a dict of numpy arrays and its text

        Keys: text, loudness (n_freq, T), pitch (T,), periodicity (T,), ppg
        (PPG_CHANNELS, T), speakers (an int id, or under ZERO_SHOT the
        stem's x-vector), spectral_balance_ratios, loudness_ratios,
        spectrograms (n_freq, T), stems and audio (1, samples).

        With `chunk_rng` (a numpy Generator) the item is a training crop
        of CHUNK_SIZE samples and CHUNK_SIZE // HOPSIZE frames: its start
        frame is chunk_rng.integers(0, T - frames + 1), the draw the JAX
        package makes, and only that window is read. An utterance shorter
        than the chunk is read whole and reflect-padded (`random_chunk`).
        Under ZERO_SHOT_SHUFFLE the x-vector is then that of another
        utterance of the speaker, drawn from `chunk_rng` as well.
        """
        config = self.config
        stem = self.stems[index]
        cache = self.cache
        pitch = load.array(cache / f'{stem}{self.viterbi}-pitch.npy')
        periodicity = load.array(
            cache / f'{stem}{self.viterbi}-periodicity.npy')
        base, ratio_pitch, ratio_loudness = self._parse_ratios(stem)
        loudness_stem = base if ratio_loudness != 1. else stem

        frames = config.CHUNK_SIZE // config.HOPSIZE
        total_frames = pitch.shape[-1]
        windowed = chunk_rng is not None and total_frames >= frames
        if windowed:
            start_frame = int(
                chunk_rng.integers(0, total_frames - frames + 1))
            window = slice(start_frame, start_frame + frames)
        else:
            window = slice(None)

        ppg_file = cache / f'{stem}-ppg.npy'
        if _frames_of(ppg_file) == total_frames:
            ppg = _windowed_load(ppg_file, window)
        else:
            ppg = load.ppg(
                ppg_file, total_frames, config, 'cpu').numpy()[..., window]
        if windowed:
            pitch = pitch[..., window]
            periodicity = periodicity[..., window]

        text_file = cache / f'{base.split("-")[0]}.txt'
        if not text_file.exists():
            text_file = cache / f'{base}.txt'
        text = load.text(text_file) if text_file.exists() else ''

        speaker_dir = stem.split('/')[0]
        if config.ZERO_SHOT:
            speaker_stem = stem
            if config.ZERO_SHOT_SHUFFLE and chunk_rng is not None:
                candidates = [
                    other for other in self.stems
                    if other.split('/')[0] == speaker_dir and other != stem]
                if candidates:
                    speaker_stem = candidates[
                        int(chunk_rng.integers(0, len(candidates)))]
            speaker = load.array(cache / f'{speaker_stem}-speaker.npy')
        else:
            speaker = np.asarray(
                self.speaker_index.get(speaker_dir, 0), np.int32)

        item = {
            'text': text,
            'loudness': _windowed_load(
                cache / f'{loudness_stem}-loudness.npy', window),
            'pitch': np.asarray(pitch, np.float32).reshape(-1),
            'periodicity': np.asarray(periodicity, np.float32).reshape(-1),
            'ppg': np.asarray(ppg, np.float32),
            'speakers': speaker,
            'spectral_balance_ratios': np.asarray(ratio_pitch, np.float32),
            'loudness_ratios': np.asarray(ratio_loudness, np.float32),
            'spectrograms': _windowed_load(
                cache / f'{stem}-spectrogram.npy', window),
            'stems': stem}

        wav = cache / f'{stem}.wav'
        if not windowed:
            item['audio'] = np.asarray(load.audio(wav, config), np.float32)
            if chunk_rng is None:
                return item
            return random_chunk(item, chunk_rng, config)
        start = start_frame * config.HOPSIZE
        chunk = (
            native_module.wav_chunk if self.native
            else native_module.wav_chunk_plain)
        item['audio'] = chunk(wav, start, config.CHUNK_SIZE)[None]
        return item

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


def ratio_file(name, kind, config):
    """The augmentation ratios of a dataset, '<name>-<kind>.json': the
    port's (config.AUGMENT_DIR, written by `data.augment`) where there is
    one, else the JAX package's shipped file (config.ASSETS_DIR /
    'augmentations'), which is only read"""
    file = config.AUGMENT_DIR / f'{name}-{kind}.json'
    if file.exists():
        return file
    return config.ASSETS_DIR / 'augmentations' / f'{name}-{kind}.json'


def random_chunk(item, rng, config):
    """An item cropped to CHUNK_SIZE samples and the matching frames

    An item shorter than the chunk keeps its whole frames and is
    reflect-padded at the end to the chunk; else the start frame is
    rng.integers(0, T - frames + 1).
    """
    hopsize = config.HOPSIZE
    chunk = config.CHUNK_SIZE
    frames = chunk // hopsize
    audio = item['audio']
    total_frames = audio.shape[-1] // hopsize
    item = dict(item)

    if total_frames < frames:
        def pad(x, amount):
            return np.pad(
                x, [(0, 0)] * (x.ndim - 1) + [(0, amount)], mode='reflect')

        item['audio'] = pad(
            audio[..., :total_frames * hopsize],
            chunk - total_frames * hopsize)
        for key in ('loudness', 'ppg', 'spectrograms', 'pitch',
                    'periodicity'):
            item[key] = pad(
                item[key][..., :total_frames], frames - total_frames)
        return item

    start_frame = int(rng.integers(0, total_frames - frames + 1))
    start = start_frame * hopsize
    item['audio'] = audio[..., start:start + chunk]
    for key in ('loudness', 'ppg', 'spectrograms', 'pitch', 'periodicity'):
        item[key] = item[key][..., start_frame:start_frame + frames]
    return item
