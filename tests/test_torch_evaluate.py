"""The port's objective evaluation held against the JAX package's.

One corpus, made by the JAX package's `data.synthetic.create` (2 speakers
x 3 utterances x 1 s), is evaluated by both packages at one edit ratio,
each with a transcriber: the shipped pitch CNN and PPG encoder on the JAX
side, the same weights carried over by the bridge and written as port
checkpoints on the port's side, and one narrow float32 generator with
shared random weights. Every job's exported features and wav files, and
every condition of results.json and of each speaker's file, must agree.
Also: the metrics on inputs with voiced frames, the word error rate, the
phoneme decoder, the timer and the command line.

Tolerances. Metric accumulators on equal inputs: 1e-12 relative (float64
host sums in both packages), the PPG distance 1e-6 (float32 sums in
another order). Whole evaluations: the generators differ by float32
rounding (about 1e-7), and the audio is preprocessed again from there, so
the exported features are held as the preprocessing parity test holds
them (loudness within 1e-2 dB, pitch 1e-4 relative, periodicity within
5e-4, PPG within 1e-4), the wav files within two 16-bit steps, and the
aggregated metrics within 1e-4 relative.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.evaluate.metrics as jax_metrics
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 32
RATIOS = [1.414]
CONDITIONS = {
    'reconstructed', 'shifted-141', 'stretched-141', 'scaled-141',
    'balance-141', 'loudness-141'}
PHASES = {'load', 'warmup', 'edit', 'generate', 'preprocess', 'transcribe'}


def _write_front_ends(directory):
    """The JAX package's pitch CNN and PPG encoder as port checkpoints"""
    save = port.utils.checkpoint.save
    save(directory / 'pitch-00000001.pt', bridge.pitch_state_dict(
        jax.device_get(jax_pitch.PitchCNN.instance().params)), step=1)
    save(directory / 'ppg-00000001.pt', bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])), step=1)


@pytest.fixture(scope='module')
def evaluations(tmp_path_factory):
    """Both packages' evaluation of one JAX-made corpus"""
    root = tmp_path_factory.mktemp('evaluate')
    assets = root / 'assets'
    assets.mkdir()
    # The JAX package reads its weights (and the transcriber's presence)
    # from ASSETS_DIR and writes partitions there: a temporary tree that
    # links to the shipped checkpoints and statistics
    for name in ('checkpoints', 'stats'):
        os.symlink(ROOT / 'promonet_tpu' / 'assets' / name, assets / name)
    cached = promonet_tpu.synthesize.core._cached_model
    with pytest.MonkeyPatch.context() as patch:
        for name, value in dict(
                CACHE_DIR=root / 'cache', ASSETS_DIR=assets,
                RESULTS_DIR=root / 'jax' / 'results',
                EVAL_DIR=root / 'jax' / 'eval', RUNS_DIR=root / 'runs',
                HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH, EVALUATION_RATIOS=RATIOS,
                PRECISION='float32').items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(cached, 'cache', {}, raising=False)
        promonet_tpu.data.synthetic.create(
            'synthetic', speakers=2, utterances=3, seconds=1.0)
        theirs = promonet_tpu.evaluate.datasets(['synthetic'], max_stems=1)
        _, params, _ = cached(None)
        checkpoints = root / 'checkpoints'
        _write_front_ends(checkpoints)
        port.utils.checkpoint.save(
            checkpoints / 'generator-00000001.pt',
            bridge.generator_state_dict(jax.device_get(params)), step=1)

    config = port.config.load().replace(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=assets / 'partitions',
        RESULTS_DIR=root / 'port' / 'results',
        EVAL_DIR=root / 'port' / 'eval', CHECKPOINTS_DIR=checkpoints,
        RUNS_DIR=root / 'runs', HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH,
        EVALUATION_RATIOS=RATIOS, PRECISION='float32')
    ours = port.evaluate.datasets(
        ['synthetic'], checkpoint=checkpoints / 'generator-00000001.pt',
        max_stems=1, config=config, device='cpu')
    return root, config, theirs['synthetic'], ours['synthetic']


###############################################################################
# Whole evaluations
###############################################################################


def _assert_metrics_close(ours, theirs):
    assert set(ours) == set(theirs)
    for name, value in theirs.items():
        if isinstance(value, dict):
            _assert_metrics_close(ours[name], value)
        else:
            np.testing.assert_allclose(ours[name], value, rtol=1e-4,
                                       err_msg=name)


def test_results_match_jax(evaluations):
    root, _, theirs, ours = evaluations
    assert set(ours['objective']) == set(theirs['objective']) == CONDITIONS
    assert ours['num_samples'] == theirs['num_samples']
    assert ours['num_frames'] == theirs['num_frames']
    # The generated audio has co-voiced frames: the pitch is compared
    assert theirs['objective']['reconstructed']['pitch'] > 0
    for condition, values in theirs['objective'].items():
        _assert_metrics_close(ours['objective'][condition], values)
    assert set(ours['benchmark']) == set(theirs['benchmark']) == PHASES
    for phase in PHASES:
        assert ours['benchmark'][phase]['seconds'] > 0
    # The files, the run's and each speaker's
    jax_dir = root / 'jax' / 'results' / 'promonet' / 'synthetic'
    port_dir = root / 'port' / 'results' / 'promonet' / 'synthetic'
    names = sorted(path.name for path in jax_dir.iterdir())
    assert names == sorted(path.name for path in port_dir.iterdir()) == [
        '0000.json', '0001.json', 'results.json']
    for name in names:
        with open(jax_dir / name) as file:
            expected = json.load(file)
        with open(port_dir / name) as file:
            written = json.load(file)
        assert written['num_samples'] == expected['num_samples']
        for condition, values in expected['objective'].items():
            _assert_metrics_close(written['objective'][condition], values)


def test_artefacts_match_jax(evaluations):
    """Every job's exported features and audio, file by file"""
    root, config, _, _ = evaluations
    theirs, ours = root / 'jax' / 'eval', root / 'port' / 'eval'
    files = sorted(path.relative_to(theirs) for path in theirs.rglob('*.*'))
    assert files == sorted(path.relative_to(ours) for path in ours.rglob('*.*'))
    # 2 stems x (6 conditions x (4 features + 1 wav) + the original)
    assert len(files) == 2 * (6 * 5 + 1)
    tolerances = {
        'loudness': dict(rtol=0, atol=1e-2), 'pitch': dict(rtol=1e-4),
        'periodicity': dict(rtol=0, atol=5e-4),
        'ppg': dict(rtol=0, atol=1e-4)}
    for file in files:
        if file.suffix == '.npy':
            expected, value = np.load(theirs / file), np.load(ours / file)
            assert value.dtype == expected.dtype == np.float32, file
            assert value.shape == expected.shape, file
            feature = file.stem.rsplit('-', 1)[1]
            np.testing.assert_allclose(
                value, expected, err_msg=str(file), **tolerances[feature])
        else:
            expected, rate = port.utils.audio.load(theirs / file)
            value, _ = port.utils.audio.load(ours / file)
            assert rate == config.SAMPLE_RATE
            assert value.shape == expected.shape, file
            np.testing.assert_allclose(
                value, expected, rtol=0, atol=2 / 32768, err_msg=str(file))


def test_card_metrics_recompute_from_the_exported_files(evaluations):
    """results.json's numbers are the metrics of the exported features"""
    root, config, _, ours = evaluations
    objective = root / 'port' / 'eval' / 'objective'
    for condition in CONDITIONS:
        metrics = port.evaluate.Metrics(include_wer=False, config=config)
        for pitch_file in sorted((objective / condition).glob('*-pitch.npy')):
            prefix = str(pitch_file)[:-len('-pitch.npy')]
            predicted = [np.load(f'{prefix}-{name}.npy') for name in (
                'loudness', 'pitch', 'periodicity', 'ppg')]
            stem = pitch_file.name.split('-')[1:3]
            edited, frames = _edited(root, config, '/'.join(stem), condition)
            metrics.update(
                edited[0].mean(axis=-2), predicted[0].mean(axis=-2),
                edited[1], edited[2], predicted[1], predicted[2], edited[3],
                predicted[3])
            assert predicted[1].shape[-1] == frames
        expected = dict(ours['objective'][condition])
        expected.pop('wer', None)
        _assert_metrics_close(metrics(), expected)


def _edited(root, config, stem, condition):
    """The edited features of one job, as the evaluation edits them"""
    features, frames = port.evaluate.core._load_features(
        config.CACHE_DIR / 'synthetic', f'{stem}-100', config.replace(
            INFERENCE_FRAME_BUCKETS=port.evaluate.core._coarse_bucket_ladder(
                'synthetic', {'': [f'{stem}-100']}, config)), 'cpu')
    shift, stretch, scale, _, _ = port.evaluate.core._conditions(
        config)[condition]
    *edited, frames = port.edit.from_padded_features(
        *features, frames, shift, stretch, scale, config)
    return [value[..., :frames].numpy() for value in edited], frames


def test_command_line_writes_the_same_conditions(evaluations, tmp_path):
    root, config, _, ours = evaluations
    config_file = tmp_path / 'evaluate.py'
    config_file.write_text(
        "MODULE = 'promonet_tpu_torch'\n"
        f"CACHE_DIR = {str(config.CACHE_DIR)!r}\n"
        f"PARTITIONS_DIR = {str(config.PARTITIONS_DIR)!r}\n"
        f"CHECKPOINTS_DIR = {str(config.CHECKPOINTS_DIR)!r}\n"
        f"RESULTS_DIR = {str(tmp_path / 'results')!r}\n"
        f"EVAL_DIR = {str(tmp_path / 'eval')!r}\n"
        f"RUNS_DIR = {str(tmp_path / 'runs')!r}\n"
        f'HIFIGAN_UPSAMPLE_INITIAL_SIZE = {WIDTH}\n'
        f'EVALUATION_RATIOS = {RATIOS!r}\n'
        "PRECISION = 'float32'\n")
    result = subprocess.run(
        [sys.executable, '-m', 'promonet_tpu_torch.evaluate', '--datasets',
         'synthetic', '--checkpoint',
         str(config.CHECKPOINTS_DIR / 'generator-00000001.pt'),
         '--max_stems', '1', '--gpu', '-1', '--config', str(config_file)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    with open(tmp_path / 'results' / 'promonet' / 'synthetic' /
              'results.json') as file:
        written = json.load(file)
    assert set(written['objective']) == CONDITIONS
    for condition, values in ours['objective'].items():
        _assert_metrics_close(written['objective'][condition], values)


def test_command_line_refuses_adaptation(tmp_path):
    """`--adapt` reaches `evaluate.datasets(adapt=True)`, which refuses a
    dataset without an adaptation partition"""
    config_file = tmp_path / 'empty.py'
    config_file.write_text(
        "MODULE = 'promonet_tpu_torch'\n"
        f"PARTITIONS_DIR = {str(tmp_path / 'partitions')!r}\n"
        f"CHECKPOINTS_DIR = {str(tmp_path / 'checkpoints')!r}\n")
    result = subprocess.run(
        [sys.executable, '-m', 'promonet_tpu_torch.evaluate', '--adapt',
         '--datasets', 'synthetic', '--gpu', '-1', '--config',
         str(config_file)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 1
    assert 'adaptation' in result.stderr and 'synthetic.json' in \
        result.stderr


def test_what_is_not_ported_raises(evaluations, tmp_path):
    """Every backbone and baseline of the JAX package is ported; what its
    generator does not define ('cargan', which is a module of its own)
    raises its ValueError in training and evaluation, and a CUDA device
    on a host without one raises"""
    _, config, _, _ = evaluations
    with pytest.raises(ValueError, match='Generator model cargan is not'):
        port.train(tmp_path, 'synthetic', config=config.replace(
            MODEL='cargan'), device='cpu')
    with pytest.raises(ValueError, match='Generator model cargan is not'):
        port.evaluate.datasets(
            ['synthetic'], config=config.replace(
                MODEL='cargan', RESULTS_DIR=tmp_path / 'results'),
            device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        port.evaluate.datasets(['synthetic'], config=config)


###############################################################################
# Metrics
###############################################################################


def _metric_inputs(seed, frames):
    """Loudness, pitch and periodicity with voiced frames, the prediction
    shifted by 100 cents, and PPG pairs that differ"""
    rng = np.random.default_rng(seed)
    pitch = rng.uniform(100, 300, frames)
    periodicity = rng.uniform(0., 1., frames)
    loudness = rng.uniform(-80, -20, frames)
    ppg = rng.dirichlet(np.full(40, .3), frames).T.astype(np.float32)
    other = rng.dirichlet(np.full(40, .3), frames).T.astype(np.float32)
    return dict(
        loudness=loudness, predicted_loudness=loudness + rng.normal(
            0, 3, frames),
        pitch=pitch, periodicity=periodicity,
        predicted_pitch=pitch * 2 ** (100 / 1200),
        predicted_periodicity=np.clip(
            periodicity + rng.normal(0, .05, frames), 0, 1),
        ppg=ppg, predicted_ppg=.5 * ppg + .5 * other,
        text='the cat sat on the mat',
        predicted_text='The cat, sat on a mat!')


def test_metrics_match_jax():
    config = port.config.load()
    ours = port.evaluate.Metrics(config=config)
    theirs = jax_metrics.Metrics()
    for seed, frames in ((0, 50), (1, 73), (2, 1)):
        inputs = _metric_inputs(seed, frames)
        ours.update(**inputs)
        theirs.update(**inputs)
    # A shorter prediction is scored over the common frames
    inputs = _metric_inputs(3, 40)
    for name in ('predicted_loudness', 'predicted_pitch',
                 'predicted_periodicity', 'predicted_ppg'):
        inputs[name] = inputs[name][..., :31]
    ours.update(**inputs)
    theirs.update(**inputs)
    expected, values = theirs(), ours()
    assert set(values) == set(expected) == {
        'loudness', 'periodicity', 'pitch', 'ppg', 'wer'}
    assert values['loudness'].keys() == expected['loudness'].keys()
    for name, value in expected['loudness'].items():
        np.testing.assert_allclose(values['loudness'][name], value, rtol=1e-12)
    for name in ('periodicity', 'pitch', 'wer'):
        np.testing.assert_allclose(values[name], expected[name], rtol=1e-12)
    np.testing.assert_allclose(values['ppg'], expected['ppg'], rtol=1e-6)
    # Co-voiced frames shifted by 100 cents
    np.testing.assert_allclose(values['pitch'], 100., rtol=1e-9)
    assert values['ppg'] > 0.1


def test_metrics_without_voiced_frames_or_transcripts():
    inputs = _metric_inputs(4, 30)
    inputs['periodicity'] = np.zeros(30)
    ours, theirs = port.evaluate.Metrics(), jax_metrics.Metrics()
    for metrics in (ours, theirs):
        metrics.update(**dict(inputs, text=None))
    expected, values = theirs(), ours()
    assert values['loudness'] == pytest.approx(expected['loudness'])
    for name in ('periodicity', 'pitch', 'ppg'):
        assert values[name] == pytest.approx(expected[name])
    assert values['pitch'] == 0. and 'wer' not in values
    ours.reset()
    assert ours()['loudness'] == {'loudness': 0.}


@pytest.mark.parametrize('target,predicted', [
    ('the cat sat', 'the cat sat'),
    ('the cat sat', 'the dog sat'),
    ('aa b ch', 'aa ch ch d'),
    ("It's   a TEST.", 'its a test'),
    ('one two three four', ''),
    ('', 'anything')])
def test_word_error_rate_matches_jax(target, predicted):
    ours, theirs = port.evaluate.metrics.WER(), jax_metrics.WER()
    ours.update(target, predicted)
    theirs.update(target, predicted)
    assert ours() == theirs() and ours.count == theirs.count
    assert port.preprocess.text.normalize(target) == \
        promonet_tpu.preprocess.text.normalize(target)


def test_spectral_balance_matches_jax():
    rng = np.random.default_rng(5)
    ours = port.evaluate.metrics.SpectralBalance()
    theirs = jax_metrics.SpectralBalance()
    for _ in range(3):
        audio = rng.standard_normal((1, 4096)).astype(np.float32)
        for metrics in (ours, theirs):
            metrics.update(audio, 0.5 * audio + 0.1 * audio ** 2)
    np.testing.assert_allclose(ours(), theirs(), rtol=1e-5)


def test_jensen_shannon_matches_jax():
    rng = np.random.default_rng(6)
    p = rng.dirichlet(np.full(40, .2), 64).T.astype(np.float32)
    q = rng.dirichlet(np.full(40, .2), 64).T.astype(np.float32)
    q[:, 3] = p[:, 3]
    q[:, 4] = 0.
    expected = np.asarray(promonet_tpu.ops.sparse.jensen_shannon(p, q))
    value = port.ops.sparse.jensen_shannon(
        torch.from_numpy(p), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(value, expected, rtol=0, atol=1e-6)
    assert value[3] == 0. and 0. < value.max() <= 1.


###############################################################################
# Transcription and timing
###############################################################################


def test_phoneme_decoder_matches_jax(tmp_path):
    """The shipped PPG encoder's transcription of formant speech"""
    rng = np.random.default_rng(7)
    audio, phones, _, _, _ = port.data.synthetic.generate_aligned_utterance(
        rng, seconds=1.5)
    expected = promonet_tpu.preprocess.text.phonemes_from_audio(audio)
    ppg_model = port.preprocess.PPGEncoder()
    ppg_model.load_state_dict(bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])))
    text = port.preprocess.text.phonemes_from_audio(
        audio, ppg_model, device='cpu')
    assert text == expected and len(text.split()) > 3
    # The JAX package's fallback transcriber is the same decoder
    assert promonet_tpu.preprocess.text.from_audio(audio) == expected
    # from_audio resolves the checkpoint in CHECKPOINTS_DIR, else the
    # shipped one; with neither, there is no transcriber
    config = port.config.load().replace(
        CHECKPOINTS_DIR=tmp_path, ASSETS_DIR=tmp_path / 'assets')
    assert not port.preprocess.text.available(config)
    with pytest.raises(RuntimeError, match='no transcriber'):
        port.preprocess.text.from_audio(audio, config=config, device='cpu')
    _write_front_ends(tmp_path)
    assert port.preprocess.text.available(config)
    assert port.preprocess.text.from_audio(
        audio, config=config, device='cpu') == expected
    wav = tmp_path / 'speech.wav'
    port.utils.audio.save(wav, audio, config.SAMPLE_RATE)
    port.preprocess.text.from_files_to_files(
        [wav], [tmp_path / 'speech.txt'], ppg_model, config, 'cpu')
    assert (tmp_path / 'speech.txt').read_text() == \
        port.preprocess.text.phonemes_from_audio(
            port.load.audio(wav), ppg_model, device='cpu')


def test_timer_phases_and_real_time_factors():
    timer = port.utils.timer.Timer('cpu')
    with timer.phase('edit'):
        sum(range(1000))
    with timer.phase('load'):
        pass
    with timer.phase('load'):
        pass
    results = timer.results()
    assert set(results) == {'edit', 'load'}
    assert all(seconds >= 0 for seconds in results.values())
    rtf = timer.rtf(22050, 22050)
    assert set(rtf) == {'edit', 'load'}
    assert rtf['edit'] == pytest.approx(1. / results['edit'])