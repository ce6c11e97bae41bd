"""The port with the repository's trained weights on one NVIDIA GPU.

Reads the converted checkpoints (`scripts/convert_checkpoints.py`, which
needs JAX, writes them to `checkpoints_torch/`) and runs, on 10 s of the
smoke's harmonic audio (4 harmonics of a vibrato around 180 Hz):

- the shipped pitch CNN and PPG encoder through `preprocess.from_audio`:
  the pitch error in cents against the signal's true fundamental, and
  the same for the 'dsp' estimator beside it;
- the edit chain, preprocess → edit (+400 cents, stretch 1/1.4, +3 dB) →
  synthesize, with the release generator under its training
  configuration (`synthetic.py`, 24 speakers), timed on its second call,
  and the pitch of the synthesized audio against the edited contour;
- the shipped speaker encoder: the x-vector of the audio, and the cosine
  between the x-vectors of two signals an octave apart;
- the objective evaluation of the release generator: the formant corpus
  regenerated as scripts/regen_corpus.py makes it (24 speakers x 56
  utterances x 2.85 s, the same random stream, so the same stems and
  partition as the shipped one), its 24 test stems preprocessed on the
  card under the release configuration (the 'dsp' pitch estimator), then
  `evaluate.datasets` over the 11 conditions with the shipped PPG encoder
  as transcriber, against the reference thresholds (pitch < 50 cents,
  periodicity < 0.1, loudness < 6 dB, PPG JSD < 0.1). Its files go to
  build/trained_evaluation/.

    python scripts/trained_weights.py [--checkpoints checkpoints_torch]

Prints one JSON line per measurement, the card's name and power limit
last. Needs a CUDA device; with none it exits 1 and runs nothing.
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import promonet_tpu_torch as port  # noqa: E402

EDIT = dict(
    pitch_shift_cents=400., time_stretch_ratio=1 / 1.4, loudness_scale_db=3.)

# The reference system's frame-error thresholds of a usable model
THRESHOLDS = dict(pitch=50., periodicity=.1, loudness=6., ppg=.1)


def harmonic_audio(seconds, sample_rate, base=180.):
    """4 harmonics of a vibrato around `base` Hz, and its fundamental at
    the frame centres"""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    pitch = base + base / 3 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / sample_rate
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def track(seconds, sample_rate, hopsize, base=180.):
    frames = int(seconds * sample_rate) // hopsize
    centers = (np.arange(frames) + 0.5) * hopsize / sample_rate
    return base + base / 3 * np.sin(2 * np.pi * 1.5 * centers)


def cents(estimate, truth):
    """Median and 90th percentile of |1200 log2(estimate / truth)|"""
    error = 1200 * np.abs(np.log2(np.asarray(estimate).ravel() / truth))
    return float(np.median(error)), float(np.percentile(error, 90))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        '--checkpoints', type=Path, default=ROOT / 'checkpoints_torch',
        help='Directory of the converted checkpoints')
    checkpoints = parser.parse_args().checkpoints
    if not torch.cuda.is_available():
        print('trained_weights: no CUDA device', file=sys.stderr)
        return 1
    device = torch.device('cuda')
    config = port.config.load(checkpoints / 'synthetic.py').replace(
        CHECKPOINTS_DIR=checkpoints, PITCH_ESTIMATOR='cnn')
    sample_rate, hopsize = config.SAMPLE_RATE, config.HOPSIZE
    pitch_model = port.load.pitch_model(config=config, device=device)
    ppg_model = port.load.ppg_model(config=config, device=device)
    encoder = port.load.speaker_encoder(config=config, device=device)
    generator = port.load.generator(
        checkpoints / 'generator-00155000.pt', config, device)
    audio = harmonic_audio(10., sample_rate)
    truth = track(10., sample_rate, hopsize)

    # Pitch of the shipped CNN, and of the 'dsp' estimator
    for estimator in ('cnn', 'dsp'):
        features = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config.replace(PITCH_ESTIMATOR=estimator), device=device)
        median, p90 = cents(features[1].cpu().numpy(), truth)
        print(json.dumps(dict(
            measure='pitch', estimator=estimator, frames=len(truth),
            median_cents=median, p90_cents=p90,
            voicing_threshold=pitch_model.voicing_threshold)), flush=True)

    # The edit chain with the release generator, second call timed
    def chain():
        features = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device)
        edited = port.edit.from_features(*features, config=config, **EDIT)
        output = port.synthesize.from_features(
            *edited, generator=generator, speaker=3, device=device)
        return edited, output

    for call in (1, 2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        edited, output = chain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    # The synthesized audio's pitch (same CNN) against the edited contour
    again = port.preprocess.from_audio(
        output, pitch_model, ppg_model, loudness_bands=None, config=config,
        device=device)
    frames = min(again[1].shape[-1], edited[1].shape[-1])
    median, p90 = cents(again[1][..., :frames].cpu().numpy(),
                        edited[1][..., :frames].cpu().numpy().ravel())
    print(json.dumps(dict(
        measure='edit_chain', ms=seconds * 1e3,
        realtime_factor=10. / seconds, samples=output.shape[-1],
        finite=bool(np.isfinite(output).all()),
        resynthesis_pitch_median_cents=median,
        resynthesis_pitch_p90_cents=p90)), flush=True)

    # The shipped speaker encoder
    start = time.perf_counter()
    xvector = port.preprocess.speaker.from_audio(
        audio, encoder, config=config, device=device)
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - start) * 1e3
    lower = port.preprocess.speaker.from_audio(
        harmonic_audio(10., sample_rate, base=90.), encoder, config=config,
        device=device)
    print(json.dumps(dict(
        measure='speaker', ms_first_call=embed_ms,
        norm=float(torch.linalg.vector_norm(xvector)),
        cosine_octave_apart=float(torch.dot(xvector, lower)))), flush=True)

    evaluation(checkpoints, device)

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else 'nvidia-smi: no output', flush=True)
    return 0


def evaluation(checkpoints, device):
    """The release generator's objective evaluation on a regenerated
    corpus; prints the corpus, preprocessing and evaluation lines"""
    directory = ROOT / 'build' / 'trained_evaluation'
    shutil.rmtree(directory, ignore_errors=True)
    config = port.config.load(checkpoints / 'synthetic.py').replace(
        CHECKPOINTS_DIR=checkpoints, CACHE_DIR=directory / 'cache',
        PARTITIONS_DIR=directory / 'partitions', EVAL_DIR=directory / 'eval',
        RESULTS_DIR=directory / 'results')

    start = time.perf_counter()
    cache = port.data.synthetic.create(
        'synthetic', speakers=24, utterances=56, seconds=2.85,
        preprocess=False, config=config, device=device)
    corpus_seconds = time.perf_counter() - start
    partition = port.load.partition('synthetic', False, config)
    with open(config.ASSETS_DIR / 'partitions' / 'multispeaker' /
              'synthetic.json') as file:
        shipped = json.load(file)
    test = partition['test']
    pitch_model = (
        port.load.pitch_model(config=config, device=device)
        if config.PITCH_ESTIMATOR == 'cnn' else None)
    ppg_model = port.load.ppg_model(config=config, device=device)
    torch.cuda.synchronize()
    start = time.perf_counter()
    port.preprocess.from_files_to_files(
        [cache / f'{stem}.wav' for stem in test], pitch_model, ppg_model,
        [cache / stem for stem in test],
        port.data.preprocess.core.FEATURES, loudness_bands=None,
        config=config, device=device)
    torch.cuda.synchronize()
    preprocess_seconds = time.perf_counter() - start
    print(json.dumps(dict(
        measure='evaluation_corpus', utterances=len(list(
            cache.glob('*/*.wav'))), seconds=corpus_seconds,
        test_stems=len(test), preprocess_seconds=preprocess_seconds,
        pitch_estimator=config.PITCH_ESTIMATOR,
        partition_equals_shipped=partition == shipped)), flush=True)

    start = time.perf_counter()
    results = port.evaluate.datasets(
        ['synthetic'], checkpoint=checkpoints / 'generator-00155000.pt',
        config=config, device=device)['synthetic']
    seconds = time.perf_counter() - start
    objective = results['objective']
    reconstructed = objective['reconstructed']
    values = dict(
        pitch=reconstructed['pitch'],
        periodicity=reconstructed['periodicity'],
        loudness=reconstructed['loudness']['loudness'],
        ppg=reconstructed['ppg'])
    print(json.dumps(dict(
        measure='evaluation', seconds=seconds,
        audio_seconds=results['num_samples'] / config.SAMPLE_RATE,
        benchmark=results['benchmark'], objective=objective,
        thresholds=THRESHOLDS,
        reconstructed_under_thresholds={
            name: value < THRESHOLDS[name] for name, value in values.items()}
    )), flush=True)


if __name__ == '__main__':
    sys.exit(main())
