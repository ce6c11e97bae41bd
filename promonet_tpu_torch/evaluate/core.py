"""Objective evaluation and its benchmark

Counterpart of `promonet_tpu/evaluate/core.py`. For each test speaker of
a dataset and each edit condition (reconstruction;
pitch shift, time stretch, loudness scale, spectral balance and loudness
ratio at each of config.EVALUATION_RATIOS), the generated audio is
preprocessed again and scored against the edited features (`Metrics`).
Artefacts follow the JAX package's layout:

    config.EVAL_DIR/objective/<condition>/<dataset>-<speaker>-<utterance>-<condition>-<feature>.npy
    config.EVAL_DIR/subjective/<condition>/<dataset>-<speaker>-<utterance>-<condition>.wav
    config.RESULTS_DIR/<CONFIG>/<dataset>/{results,<speaker>}.json

Under MODEL='world' (configs/baselines/world.py) the WORLD baseline
generates each job from the stem's wav on the host (`baseline.world`),
with the edit's pitch and, for a stretch, the exact-length grid of the
edit; its audio is then preprocessed again on the device as every
model's is.

With adaptation (`adapt`), the speakers are those of the dataset's
adaptation partition: each speaker's `train-adapt-NN` partition first
fine-tunes the base generator (`train`, ADAPTATION_STEPS more steps, in
config.RUNS_DIR / CONFIG / 'adapt' / <dataset> / NN; a run that has a
checkpoint is not trained again), then its `test-adapt-NN` utterances
are scored with that generator as its speaker 0.

What sets the numbers is reproduced from the JAX package:
- the run's bucket ladder: the bucket of the longest utterance and the
  buckets its stretches land in (`_coarse_bucket_ladder`), as
  config.INFERENCE_FRAME_BUCKETS for everything the run calls;
- input features padded to their bucket by repeating the last frame,
  and edited there (`edit.from_padded_features`), so the generator sees
  the same padded tail;
- generation batched by output bucket (`synthesize.from_features_batched`);
- every job's audio zero-padded to the run's top bucket before it is
  preprocessed again, and its features cut to its true frames.

The JAX package fans each phase over a thread pool; here the jobs of a
phase run in order, on one stream. Each phase (`load`, `warmup`, `edit`,
`generate`, `preprocess`, `transcribe`) is timed by a `utils.timer.Timer`
that synchronises with the card, and reported with its real-time factor.
Before each timed phase one job per bucket runs under `warmup`, so the
kernels' first loads and cuDNN's first plans are not in the timed phases.
"""
import contextlib
import json

import numpy as np
import torch

from .. import config as config_module
from .. import convert
from .. import device as device_module
from .. import edit
from .. import load
from .. import preprocess
from .. import synthesize
from ..baseline import mels as mels_baseline, world as world_baseline
from ..data import Dataset, bucket_frames
from ..preprocess import text as text_module
from ..utils import audio as audio_module
from ..utils import checkpoint as checkpoint_module
from ..utils import cli
from ..utils import pause
from ..utils.notify import notify
from ..utils.timer import Timer
from .metrics import Metrics

# The features each job's audio is preprocessed into again
PREDICTED = ('loudness', 'pitch', 'periodicity', 'ppg')


@notify('evaluate')
def datasets(
    datasets=None,
    checkpoint=None,
    gpu=None,
    max_stems=None,
    adapt=None,
    config=None,
    device='cuda'
):
    """Evaluate the test partition of each dataset; returns the results
    of each by name, as written to its results.json

    Arguments
        datasets: names under config.CACHE_DIR; None takes
            [config.TRAINING_DATASET]
        checkpoint: the generator (`load.generator`): a port checkpoint
            file or a directory of them; None resolves as there
        gpu: a GPU index as the command line takes it (`utils.cli`),
            overriding `device`; -1 is the CPU
        max_stems: evaluate at most this many utterances per speaker
        adapt: adapt the generator to each speaker of the adaptation
            partition first (None takes config.ADAPTATION)
        config: a `config.Config`; None reads the environment's
        device: where to run; 'cuda' raises on a host without a card

    The pitch CNN and the PPG encoder are `load.pitch_model` and
    `load.ppg_model` of config. Transcripts are scored where
    `preprocess.text.available`.

    The run is reported by `utils.notify` ('evaluate') and holds the card
    alone (`utils.pause.exclusive`): a trainer registered under
    config.RUNS_DIR is paused for its duration, so that no timed phase
    measures contention.
    """
    config = config_module.default() if config is None else config
    with pause.exclusive(config=config):
        return _datasets(
            datasets, checkpoint, gpu, max_stems, adapt, config, device)


def _datasets(datasets, checkpoint, gpu, max_stems, adapt, config, device):
    if gpu is not None:
        device = cli.device(gpu)
    device = device_module.resolve(device)
    if datasets is None:
        datasets = [config.TRAINING_DATASET]
    if adapt is None:
        adapt = config.ADAPTATION

    aggregate = {}
    for name in datasets:
        if adapt:
            stems_by_speaker = _adaptation_speakers(name, config)
        else:
            stems_by_speaker = {}
            for stem in load.partition(name, False, config)['test']:
                stems_by_speaker.setdefault(
                    stem.split('/')[0], []).append(stem)
        if max_stems is not None:
            stems_by_speaker = {
                speaker_id: stems[:max_stems]
                for speaker_id, stems in stems_by_speaker.items()}
        run_config = config.replace(INFERENCE_FRAME_BUCKETS=list(
            _coarse_bucket_ladder(name, stems_by_speaker, config)))
        timer = Timer(device)
        # WORLD has no generator to load: as in the JAX package, no 'load'
        # phase (the extractors load untimed)
        world = config.MODEL == 'world'
        with contextlib.nullcontext() if world else timer.phase('load'):
            models = _models(
                None if adapt else checkpoint, run_config, device,
                generator=not (adapt or world))
        include_wer = text_module.available(run_config)
        dataset_metrics = _condition_metrics(include_wer, run_config)
        speaker_index = (
            {} if adapt else Dataset(name, 'test', run_config).speaker_index)

        results = {'num_samples': 0, 'num_frames': 0, 'speakers': {}}
        for speaker_id, stems in stems_by_speaker.items():
            if adapt:
                # Adapted generators are single-speaker: speaker 0
                adapted = _adapt_speaker(
                    name, speaker_id, checkpoint, run_config, device)
                with timer.phase('load'):
                    models = (*models[:2], load.generator(
                        adapted, run_config, device))
            speaker_results = speaker(
                name, speaker_id, stems, speaker_index.get(speaker_id, 0),
                models, dataset_metrics, timer, include_wer, run_config,
                device)
            results['speakers'][speaker_id] = speaker_results
            results['num_samples'] += speaker_results['num_samples']
            results['num_frames'] += speaker_results['num_frames']

        results['objective'] = {
            condition: metrics()
            for condition, metrics in dataset_metrics.items()}
        rtf = timer.rtf(results['num_samples'], config.SAMPLE_RATE)
        results['benchmark'] = {
            phase: {'seconds': wall, 'rtf': rtf[phase]}
            for phase, wall in timer.results().items()}

        directory = config.RESULTS_DIR / config.CONFIG / name
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / 'results.json', 'w') as file:
            json.dump(results, file, indent=4, default=float)
        for speaker_id, speaker_results in results['speakers'].items():
            with open(directory / f'{speaker_id}.json', 'w') as file:
                json.dump(speaker_results, file, indent=4, default=float)
        aggregate[name] = results
    return aggregate


def speaker(
    dataset,
    speaker_id,
    stems,
    speaker_index,
    models,
    dataset_metrics,
    timer,
    include_wer,
    config,
    device
):
    """Evaluate one speaker's utterances in every condition

    Arguments
        dataset, speaker_id, stems: the utterances (cache stems)
        speaker_index: the generator's speaker id for them
        models: (pitch CNN or None, PPG encoder, generator), on `device`
        dataset_metrics: {condition: Metrics} of the whole dataset, which
            this speaker's jobs update too
        timer: the run's `utils.timer.Timer`
        include_wer: transcribe and score the transcripts
        config: the run's configuration (its bucket ladder included)

    Returns
        {'num_samples', 'num_frames', 'objective': {condition: metrics}}
    """
    cache = config.CACHE_DIR / dataset
    speaker_metrics = _condition_metrics(include_wer, config)
    num_samples = num_frames = 0

    jobs = []
    for stem in stems:
        features, frames = _load_features(cache, stem, config, device)
        num_frames += frames
        num_samples += frames * config.HOPSIZE
        key_base = f'{dataset}-{stem.replace("/", "-")}'

        text = None
        if include_wer:
            text_file = cache / f'{stem.split("-")[0]}.txt'
            if not text_file.exists():
                text_file = cache / f'{stem}.txt'
            if text_file.exists():
                text = text_module.normalize(text_file.read_text())

        original = load.audio(cache / f'{stem}.wav', config)
        trim = original.shape[-1] % config.HOPSIZE
        if trim:
            original = original[..., :-trim]
        _export_audio(config, 'original', f'{key_base}-original', original)

        for condition, spec in _conditions(config).items():
            if config.SPECTROGRAM_ONLY and condition != 'reconstructed':
                continue
            jobs.append({
                'stem': stem,
                'condition': condition,
                'key': f'{key_base}-{condition}',
                'features': features,
                'frames': frames,
                'spec': spec,
                'text': text})

    _run_conditions(
        jobs, cache, speaker_index, models, timer, include_wer, config,
        device)

    # Scores and artefacts, on the host, untimed
    for job in jobs:
        edited = [
            value[..., :job['edited_frames']].cpu().numpy()
            for value in job['edited']]
        predicted = [value.cpu().numpy() for value in job['predicted']]
        condition = job['condition']
        _export_audio(
            config, condition, job['key'], job['generated'].cpu().numpy())
        _export_features(
            config, condition, job['key'],
            **dict(zip(PREDICTED, predicted)))
        update = dict(
            loudness=edited[0].mean(axis=-2),
            predicted_loudness=predicted[0].mean(axis=-2),
            pitch=edited[1],
            periodicity=edited[2],
            predicted_pitch=predicted[1],
            predicted_periodicity=predicted[2],
            ppg=edited[3],
            predicted_ppg=predicted[3],
            text=job['text'],
            predicted_text=job.get('predicted_text'))
        speaker_metrics[condition].update(**update)
        dataset_metrics[condition].update(**update)

    return {
        'num_samples': num_samples,
        'num_frames': num_frames,
        'objective': {
            condition: metrics()
            for condition, metrics in speaker_metrics.items()}}


def _run_conditions(
    jobs, cache, speaker_index, models, timer, include_wer, config, device
):
    """Edit → generate → preprocess again → transcribe, one timed phase
    each, every job in turn"""
    pitch_model, ppg_model, generator = models
    ladder = config.INFERENCE_FRAME_BUCKETS

    def representatives(items, bucket_of):
        seen = {}
        for job in items:
            seen.setdefault(bucket_of(job), job)
        return list(seen.values())

    def edit_job(job):
        shift, stretch, scale, _, _ = job['spec']
        *job['edited'], job['edited_frames'] = edit.from_padded_features(
            *job['features'], job['frames'], shift, stretch, scale, config)

    def edit_key(job):
        stretch = job['spec'][1]
        return (
            bucket_frames(job['frames'], ladder),
            bucket_frames(int(round(job['frames'] / stretch)), ladder)
            if stretch is not None else None,
            job['spec'][0] is not None)

    with timer.phase('warmup'):
        for job in representatives(jobs, edit_key):
            edit_job(job)
    with timer.phase('edit'):
        for job in jobs:
            edit_job(job)

    def output_bucket(job):
        return job['edited'][1].shape[-1]

    def generate_group(group):
        audio = synthesize.from_features_batched(
            [job['edited'] for job in group],
            generator,
            speakers=[speaker_index] * len(group),
            spectral_balance_ratios=[job['spec'][3] for job in group],
            loudness_ratios=[job['spec'][4] for job in group],
            device=device)
        for row, job in enumerate(group):
            job['generated'] = audio[
                row, :, :job['edited_frames'] * config.HOPSIZE]

    def generate_mels(job):
        spectrogram = load.array(cache / f'{job["stem"]}-spectrogram.npy')
        job['generated'] = torch.from_numpy(mels_baseline.from_features(
            spectrogram, generator, speaker_index, job['spec'][3],
            job['spec'][4], device)).to(device)

    def generate_world(job):
        frames, out_frames = job['frames'], job['edited_frames']
        # A stretch samples the exact-length grid over the input's frames
        grid = None
        if job['spec'][1] is not None:
            grid = torch.linspace(0., frames - 1, out_frames).numpy()
        job['generated'] = torch.from_numpy(world_baseline.from_audio(
            load.audio(cache / f'{job["stem"]}.wav', config),
            grid=grid,
            pitch=job['edited'][1][..., :out_frames].cpu().numpy(),
            config=config)).to(device)

    if config.SPECTROGRAM_ONLY or config.MODEL == 'world':
        generate_job = (
            generate_mels if config.SPECTROGRAM_ONLY else generate_world)
        with timer.phase('warmup'):
            for job in representatives(jobs, output_bucket):
                generate_job(job)
        with timer.phase('generate'):
            for job in jobs:
                generate_job(job)
    else:
        groups = {}
        for job in jobs:
            groups.setdefault(output_bucket(job), []).append(job)
        with timer.phase('warmup'):
            for job in representatives(jobs, output_bucket):
                generate_group([job])
        with timer.phase('generate'):
            for group in groups.values():
                generate_group(group)

    top_bucket = max((output_bucket(job) for job in jobs), default=0)
    samples = top_bucket * config.HOPSIZE

    def preprocess_job(job):
        generated = job['generated']
        frames = generated.shape[-1] // config.HOPSIZE
        audio = torch.nn.functional.pad(
            generated.float(), (0, samples - generated.shape[-1]))
        job['predicted'] = tuple(
            value[..., :frames] for value in preprocess.from_audio(
                audio, pitch_model, ppg_model, features=PREDICTED,
                loudness_bands=None, config=config, device=device))

    def generated_bucket(job):
        return bucket_frames(
            job['generated'].shape[-1] // config.HOPSIZE, ladder)

    with timer.phase('warmup'):
        for job in representatives(jobs, generated_bucket):
            preprocess_job(job)
    with timer.phase('preprocess'):
        for job in jobs:
            preprocess_job(job)

    if include_wer:
        def transcribe_job(job):
            if job['text']:
                job['predicted_text'] = text_module.normalize(
                    text_module.from_audio(
                        job['generated'], ppg_model, config=config,
                        device=device))

        scored = [job for job in jobs if job['text']]
        with timer.phase('warmup'):
            for job in representatives(scored, generated_bucket):
                transcribe_job(job)
        with timer.phase('transcribe'):
            for job in jobs:
                transcribe_job(job)


###############################################################################
# Artefacts
###############################################################################


def _export_audio(config, condition, key, audio):
    """Write audio under EVAL_DIR/subjective/<condition>/<key>.wav"""
    directory = config.EVAL_DIR / 'subjective' / condition
    directory.mkdir(parents=True, exist_ok=True)
    audio_module.save(directory / f'{key}.wav', audio, config.SAMPLE_RATE)


def _export_features(config, condition, key, **features):
    """Write features under EVAL_DIR/objective/<condition>/<key>-<name>.npy"""
    directory = config.EVAL_DIR / 'objective' / condition
    directory.mkdir(parents=True, exist_ok=True)
    for name, value in features.items():
        np.save(directory / f'{key}-{name}.npy', value)


###############################################################################
# Internals
###############################################################################


def _conditions(config):
    """{condition: (cents, stretch, dB, spectral balance, loudness ratio)}"""
    conditions = {'reconstructed': (None, None, None, 1., 1.)}
    for ratio in config.EVALUATION_RATIOS:
        key = f'{int(round(100 * ratio)):03d}'
        conditions[f'shifted-{key}'] = (
            convert.ratio_to_cents(ratio), None, None, 1., 1.)
        conditions[f'stretched-{key}'] = (None, ratio, None, 1., 1.)
        conditions[f'scaled-{key}'] = (
            None, None, convert.ratio_to_db(ratio), 1., 1.)
        conditions[f'balance-{key}'] = (None, None, None, ratio, 1.)
        conditions[f'loudness-{key}'] = (None, None, None, 1., ratio)
    return conditions


def _condition_metrics(include_wer, config):
    return {
        condition: Metrics(include_wer, config)
        for condition in _conditions(config)}


def _models(checkpoint, config, device, generator=True):
    """(pitch CNN or None, PPG encoder, generator or None) of the run"""
    pitch_model = (
        load.pitch_model(config=config, device=device)
        if config.PITCH_ESTIMATOR == 'cnn' else None)
    return (
        pitch_model,
        load.ppg_model(config=config, device=device),
        load.generator(checkpoint, config, device) if generator else None)


def _adaptation_speakers(name, config):
    """{speaker id: sorted test stems} of each test-adapt-<id> split"""
    partition = load.partition(name, True, config)
    return {
        key[len('test-adapt-'):]: sorted(partition[key])
        for key in sorted(partition) if key.startswith('test-adapt-')}


def _adapt_speaker(name, speaker_id, base_checkpoint, config, device):
    """The newest checkpoint of the speaker's adaptation run, which is
    trained first from `base_checkpoint` where it has none"""
    from ..train import train

    directory = config.RUNS_DIR / config.CONFIG / 'adapt' / name / speaker_id
    directory.mkdir(parents=True, exist_ok=True)
    if checkpoint_module.latest_path(directory) is None:
        train(
            directory, dataset=name,
            train_partition=f'train-adapt-{speaker_id}',
            valid_partition=f'test-adapt-{speaker_id}',
            adapt_from=base_checkpoint, config=config, device=device)
    return checkpoint_module.latest_path(directory)


def _coarse_bucket_ladder(dataset, stems_by_speaker, config):
    """The run's buckets: that of the longest utterance and those its
    stretches by each of EVALUATION_RATIOS and their inverses land in"""
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    cache = config.CACHE_DIR / dataset
    buckets = config.INFERENCE_FRAME_BUCKETS
    max_frames = 1
    for stems in stems_by_speaker.values():
        for stem in stems:
            try:
                header = np.load(
                    cache / f'{stem}{viterbi}-pitch.npy', mmap_mode='r')
            except FileNotFoundError:
                continue
            max_frames = max(max_frames, header.shape[-1])
    rungs = {bucket_frames(max_frames, buckets)}
    for ratio in config.EVALUATION_RATIOS:
        for direction in (ratio, 1. / ratio):
            rungs.add(bucket_frames(
                int(np.ceil(max_frames / direction)), buckets))
    return sorted(rungs)


def _load_features(cache, stem, config, device):
    """A stem's loudness, pitch, periodicity and PPG on `device`, each
    padded to its bucket by repeating the last frame; and its frames"""
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    pitch = load.array(cache / f'{stem}{viterbi}-pitch.npy')
    frames = pitch.shape[-1]
    features = (
        load.array(cache / f'{stem}-loudness.npy'),
        pitch,
        load.array(cache / f'{stem}{viterbi}-periodicity.npy'),
        load.ppg(cache / f'{stem}-ppg.npy', frames, config, 'cpu').numpy())
    bucket = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)
    return tuple(
        torch.from_numpy(np.pad(
            np.asarray(value, np.float32),
            [(0, 0)] * (value.ndim - 1) + [(0, bucket - frames)],
            mode='edge')).to(device)
        for value in features), frames
