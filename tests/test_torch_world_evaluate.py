"""The evaluation of the WORLD baseline held against the JAX package's.

One corpus, made by the JAX package's `data.synthetic.create` (2 speakers
x 3 utterances x 1 s), evaluated under MODEL='world'
(configs/baselines/world.py) by both packages at one edit ratio, with
the shipped pitch CNN and PPG encoder on the JAX side and the same
weights carried over by the bridge on the port's (as
`test_torch_evaluate.py` does). Each job's WORLD audio comes from the
stem's wav with the edit's pitch and, for a stretch, the exact-length
grid, and is preprocessed again on the device.

Tolerances. The WORLD audio is equal where the edit's pitch is (the
reconstruction, the loudness and balance conditions, the pitch shift);
under the stretch the edit's pitch and grid differ by float32 rounding
(log2 and exp2 in another library, `jnp.linspace`'s own arithmetic), and
the audio is held within two 16-bit steps as every wav is. The exported
features follow `test_torch_evaluate.py`'s tolerances (loudness within
1e-2 dB, pitch 1e-4 relative, periodicity within 5e-4, PPG within 1e-4),
and every condition's metrics agree within 1e-4 relative.
"""
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

import promonet_tpu

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

from test_torch_evaluate import (
    RATIOS, _assert_metrics_close, _write_front_ends)

ROOT = Path(__file__).resolve().parent.parent
CONDITIONS = {
    'reconstructed', 'shifted-141', 'stretched-141', 'scaled-141',
    'balance-141', 'loudness-141'}


@pytest.fixture(scope='module')
def evaluations(tmp_path_factory):
    root = tmp_path_factory.mktemp('world')
    assets = root / 'assets'
    assets.mkdir()
    for name in ('checkpoints', 'stats'):
        os.symlink(ROOT / 'promonet_tpu' / 'assets' / name, assets / name)
    with pytest.MonkeyPatch.context() as patch:
        for name, value in dict(
                CACHE_DIR=root / 'cache', ASSETS_DIR=assets,
                RESULTS_DIR=root / 'jax' / 'results',
                EVAL_DIR=root / 'jax' / 'eval', RUNS_DIR=root / 'runs',
                EVALUATION_RATIOS=RATIOS, MODEL='world',
                CONFIG='world').items():
            patch.setattr(promonet_tpu, name, value)
        promonet_tpu.data.synthetic.create(
            'synthetic', speakers=2, utterances=3, seconds=1.0)
        theirs = promonet_tpu.evaluate.datasets(['synthetic'], max_stems=1)
    checkpoints = root / 'checkpoints'
    _write_front_ends(checkpoints)
    config = port.config.load(
        ROOT / 'configs' / 'baselines' / 'world.py').replace(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=assets / 'partitions',
        RESULTS_DIR=root / 'port' / 'results',
        EVAL_DIR=root / 'port' / 'eval', CHECKPOINTS_DIR=checkpoints,
        RUNS_DIR=root / 'runs', EVALUATION_RATIOS=RATIOS)
    ours = port.evaluate.datasets(
        ['synthetic'], max_stems=1, config=config, device='cpu')
    return root, config, theirs['synthetic'], ours['synthetic']


def _leaves(value):
    if isinstance(value, dict):
        for item in value.values():
            yield from _leaves(item)
    else:
        yield float(value)


def test_world_results_match_jax(evaluations):
    root, config, theirs, ours = evaluations
    assert config.MODEL == 'world' and config.CONFIG == 'world'
    assert set(ours['objective']) == set(theirs['objective']) == CONDITIONS
    assert ours['num_samples'] == theirs['num_samples']
    for condition, values in theirs['objective'].items():
        _assert_metrics_close(ours['objective'][condition], values)
        for name in ('loudness', 'periodicity', 'ppg'):
            assert np.isfinite(np.asarray(
                list(_leaves(ours['objective'][condition][name])))).all()
    assert set(ours['benchmark']) == set(theirs['benchmark'])
    for name in ('results.json', '0000.json', '0001.json'):
        written = json.loads((
            root / 'port' / 'results' / 'world' / 'synthetic' /
            name).read_text())
        expected = json.loads((
            root / 'jax' / 'results' / 'world' / 'synthetic' /
            name).read_text())
        for condition, values in expected['objective'].items():
            _assert_metrics_close(written['objective'][condition], values)


def test_world_artefacts_match_jax(evaluations):
    root, config, _, _ = evaluations
    theirs, ours = root / 'jax' / 'eval', root / 'port' / 'eval'
    files = sorted(path.relative_to(theirs) for path in theirs.rglob('*.*'))
    assert files == sorted(
        path.relative_to(ours) for path in ours.rglob('*.*'))
    assert len(files) == 2 * (6 * 5 + 1)
    tolerances = {
        'loudness': dict(rtol=0, atol=1e-2), 'pitch': dict(rtol=1e-4),
        'periodicity': dict(rtol=0, atol=5e-4),
        'ppg': dict(rtol=0, atol=1e-4)}
    for file in files:
        if file.suffix == '.npy':
            expected, value = np.load(theirs / file), np.load(ours / file)
            assert value.shape == expected.shape, file
            feature = file.stem.rsplit('-', 1)[1]
            np.testing.assert_allclose(
                value, expected, err_msg=str(file), **tolerances[feature])
            continue
        expected, _ = port.utils.audio.load(theirs / file)
        value, _ = port.utils.audio.load(ours / file)
        assert value.shape == expected.shape, file
        if 'stretched' in file.name:
            np.testing.assert_allclose(
                value, expected, rtol=0, atol=2 / 32768, err_msg=str(file))
        else:
            np.testing.assert_array_equal(value, expected, err_msg=str(file))


def test_world_generation_is_the_baseline_on_the_stem(evaluations):
    """A job's wav is `baseline.world.from_audio` of the stem's wav with
    the edit's pitch, written as 16-bit audio (within two steps, as the
    wav files are compared)"""
    root, config, _, _ = evaluations
    cache = config.CACHE_DIR / 'synthetic'
    stem = sorted((cache / '0000').glob('*.wav'))[-1]
    pitch = np.load(str(stem)[:-len('.wav')] + '-viterbi-pitch.npy')
    generated = port.baseline.world.from_audio(
        port.load.audio(stem, config), pitch=pitch, config=config)
    key = f'synthetic-0000-{stem.stem}-reconstructed.wav'
    written, _ = port.utils.audio.load(
        root / 'port' / 'eval' / 'subjective' / 'reconstructed' / key)
    assert written.shape == generated.shape
    np.testing.assert_allclose(written, generated, rtol=0, atol=2 / 32768)
