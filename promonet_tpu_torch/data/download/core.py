"""Dataset formatting (counterpart of `promonet_tpu/data/download/core.py`)

Formats the published datasets (DAPS, LibriTTS, VCTK), extracted under
config.DATA_DIR / <dataset>, into the cache layout that the rest of the
data pipeline reads, config.CACHE_DIR / <dataset> /
<speaker-index> / <utterance>-100.wav + .txt. Nothing is fetched: an
archive must already be extracted there. The files written are the JAX
package's, byte for byte:

- speaker directories numbered by order of first appearance over the
  sorted audio paths (DAPS sorts them resolved, LibriTTS as found);
- each utterance written twice: `<count>.wav` at its own rate and
  `<count>-100.wav` at SAMPLE_RATE (`utils.audio.resample`);
- quiet audio gained up to a peak of PEAK_TARGET, in float32;
- LibriTTS: `.normalized.txt` transcripts, and `speakers.json`, the map
  from corpus speaker IDs to [cache index, utterance count], which
  `partition` reads to find the held-out speakers;
- VCTK: the audio under `wav48_silence_trimmed/` (else the root), the
  transcript of `<stem>_micN` under `txt/<speaker>/<stem>.txt`, an
  utterance without one dropped, and `correspondence.json`, each cache
  stem's source stem, which `partition` reads so that no other
  microphone's take of a test utterance lands in another split.

Formatting is host work (scipy file IO and resampling).
"""
import json
from pathlib import Path

import numpy as np

from ... import config as config_module
from ...utils import audio as audio_module
from ...utils.notify import notify

# Peak that quiet audio is gained up to
PEAK_TARGET = 0.35


@notify('download')
def datasets(datasets=None, config=None):
    """Format each dataset of `datasets` (None: config.DATASETS) found
    under config.DATA_DIR into config.CACHE_DIR"""
    config = config_module.default() if config is None else config
    for name in config.DATASETS if datasets is None else datasets:
        source = config.DATA_DIR / name
        if not source.exists():
            raise FileNotFoundError(
                f'Dataset {name} not found at {source}. Nothing is '
                'downloaded; place the extracted dataset there (see '
                'config.DATA_DIR) or use '
                'promonet_tpu_torch.data.synthetic.create() for testing.')
        if name == 'daps':
            daps(source, config)
        elif name == 'libritts':
            libritts(source, config)
        elif name == 'vctk':
            vctk(source, config)
        else:
            format_generic(name, source, config)


###############################################################################
# Published datasets
###############################################################################


def daps(source=None, config=None):
    """Format the DAPS tree; the speaker is the first '_'-separated token of
    a file's name ('f1_script1_clean.wav' is speaker 'f1')"""
    config = config_module.default() if config is None else config
    source = Path(source or config.DATA_DIR / 'daps')
    audio_files = sorted(path.resolve() for path in source.rglob('*.wav'))
    pairs = [(audio, audio.with_suffix('.txt')) for audio in audio_files]
    _format_files(
        'daps', pairs, lambda stem: stem.split('_')[0], config)


def libritts(source=None, config=None):
    """Format a LibriTTS tree of '<speaker>_<chapter>_<utt>_<seg>.wav' with
    '.normalized.txt' transcripts; writes speakers.json"""
    config = config_module.default() if config is None else config
    source = Path(source or config.DATA_DIR / 'libritts')
    audio_files = sorted(source.rglob('*.wav'))
    pairs = [
        (audio, audio.with_suffix('.normalized.txt'))
        for audio in audio_files]
    speaker_count = _format_files(
        'libritts', pairs, lambda stem: stem.split('_')[0], config)
    with open(config.CACHE_DIR / 'libritts' / 'speakers.json', 'w') as file:
        json.dump(speaker_count, file, indent=4, sort_keys=True)


def vctk(source=None, config=None):
    """Format a VCTK tree: '<speaker>_<utt>_micN' audio, transcripts under
    txt/<speaker>/<speaker>_<utt>.txt, utterances without one dropped;
    writes correspondence.json"""
    config = config_module.default() if config is None else config
    source = Path(source or config.DATA_DIR / 'vctk')
    audio_root = source / 'wav48_silence_trimmed'
    if not audio_root.exists():
        audio_root = source

    def text_of(audio_file):
        return (
            source / 'txt' / audio_file.parent.name /
            f'{audio_file.stem[:-5]}.txt')

    audio_files = sorted(
        list(audio_root.rglob('*.flac')) + list(audio_root.rglob('*.wav')))
    pairs = [
        (audio, text_of(audio)) for audio in audio_files
        if text_of(audio).exists()]
    _format_files(
        'vctk', pairs, lambda stem: stem.split('_')[0], config,
        correspondence=True)


def _format_files(name, pairs, speaker_of, config, correspondence=False):
    """Write (audio, text) pairs into the cache layout of `name`; returns
    {speaker: [index, count]}, indices in order of first appearance"""
    cache = config.CACHE_DIR / name
    cache.mkdir(parents=True, exist_ok=True)
    speaker_count, stem_map = {}, {}
    for audio_file, text_file in pairs:
        speaker = speaker_of(audio_file.stem)
        if speaker not in speaker_count:
            speaker_count[speaker] = [len(speaker_count), 0]
        speaker_count[speaker][1] += 1
        index, count = speaker_count[speaker]
        count -= 1

        audio, sample_rate = _load_any(audio_file)
        audio = normalize_gain(audio)

        speaker_dir = cache / f'{index:04d}'
        speaker_dir.mkdir(parents=True, exist_ok=True)
        audio_module.save(
            speaker_dir / f'{count:06d}.wav', audio, sample_rate)
        audio_module.save(
            speaker_dir / f'{count:06d}-100.wav',
            audio_module.resample(audio, sample_rate, config.SAMPLE_RATE),
            config.SAMPLE_RATE)
        if text_file.exists():
            (speaker_dir / f'{count:06d}.txt').write_text(
                text_file.read_text(encoding='utf-8'), encoding='utf-8')
        stem_map[f'{index:04d}/{count:06d}-100'] = audio_file.stem

    if correspondence:
        with open(cache / 'correspondence.json', 'w') as file:
            json.dump(stem_map, file)
    return speaker_count


def _load_any(file):
    """An audio file and its rate; FLAC needs a decoder, which neither
    package has"""
    if file.suffix.lower() == '.flac':
        raise RuntimeError(
            f'{file}: FLAC decoding requires a local decoder (none is '
            'available in this environment); convert the tree to wav '
            'first, e.g. with ffmpeg or soundfile where available')
    return audio_module.load(file)


###############################################################################
# Other datasets
###############################################################################


def format_generic(name, source, config=None):
    """Format a <speaker>/<utterance>.wav [+ .txt] tree: speakers in sorted
    order, each utterance at SAMPLE_RATE only"""
    config = config_module.default() if config is None else config
    cache = config.CACHE_DIR / name
    speakers = sorted(d for d in Path(source).iterdir() if d.is_dir())
    for index, speaker_dir in enumerate(speakers):
        out_dir = cache / f'{index:04d}'
        out_dir.mkdir(parents=True, exist_ok=True)
        for utterance, wav in enumerate(sorted(speaker_dir.glob('**/*.wav'))):
            audio, _ = audio_module.load(wav, config.SAMPLE_RATE)
            stem = f'{utterance:06d}-100'
            audio_module.save(
                out_dir / f'{stem}.wav', normalize_gain(audio),
                config.SAMPLE_RATE)
            text = wav.with_suffix('.txt')
            if text.exists():
                (out_dir / f'{stem}.txt').write_text(
                    text.read_text(encoding='utf-8'), encoding='utf-8')


def normalize_gain(audio, target=PEAK_TARGET):
    """Audio whose peak lies in (0, target) gained up to `target`, in
    float32; other audio unchanged"""
    peak = np.abs(audio).max()
    if 0 < peak < target:
        return (audio * (target / peak)).astype(np.float32)
    return audio
