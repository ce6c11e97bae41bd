"""Adaptation-mode evaluation and speaker adaptation, against the JAX
package.

One corpus (1 speaker x 4 utterances x 0.5 s, made and augmented by the
port, preprocessed with the shipped pitch CNN and PPG encoder on the JAX
side's copy and with the same weights carried over on the port's) gets
per-speaker adaptation partitions (two test utterances) from each
package; then each package's `evaluate.datasets(adapt=True)`, with
ADAPTATION_STEPS 1 from one narrow float32 generator (32 channels, the
JAX package's random weights, written in each package's checkpoint
format at step 1), fine-tunes it on the speaker's train-adapt partition
and scores the test-adapt one. The partitions must be equal, the runs
lie in the same directories with the same checkpoint steps, and
results.json must have the same keys at every level. The values differ:
each package starts its discriminators from its own random weights.
"""
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

import promonet_tpu
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from test_torch_train import drop_large_files

ROOT = Path(__file__).resolve().parent.parent
NARROW = dict(
    HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
    PRECISION='float32', REMAT=False, STEPS=0, ADAPTATION_STEPS=1,
    EVALUATION_RATIOS=[1.414])


@pytest.fixture(scope='module', autouse=True)
def _quiet():
    """No TensorBoard writer (its import brings in TensorFlow where
    installed)"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            port.utils.log, '_tensorboard_writer', lambda directory: None)
        yield


def _keys(tree):
    """The nested keys of a results dict"""
    if isinstance(tree, dict):
        return {key: _keys(value) for key, value in tree.items()}
    return None


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    yield
    drop_large_files(tmp_path)


@pytest.fixture(scope='module')
def adapted(tmp_path_factory):
    root = tmp_path_factory.mktemp('adapt')
    assets = root / 'assets'
    assets.mkdir()
    for name in ('checkpoints', 'stats'):
        os.symlink(ROOT / 'promonet_tpu' / 'assets' / name, assets / name)
    checkpoints = root / 'checkpoints'
    save = port.utils.checkpoint.save
    save(checkpoints / 'pitch-00000001.pt', bridge.pitch_state_dict(
        jax.device_get(jax_pitch.PitchCNN.instance().params)), step=1)
    save(checkpoints / 'ppg-00000001.pt', bridge.ppg_state_dict(
        jax.device_get(jax_ppg._model()[1])), step=1)
    config = port.config.load().replace(
        CACHE_DIR=root / 'port' / 'cache',
        PARTITIONS_DIR=root / 'port' / 'partitions',
        AUGMENT_DIR=root / 'augmentations', RUNS_DIR=root / 'port' / 'runs',
        RESULTS_DIR=root / 'port' / 'results', EVAL_DIR=root / 'port' / 'eval',
        CHECKPOINTS_DIR=checkpoints, **NARROW)
    port.data.synthetic.create(
        speakers=1, utterances=4, seconds=0.5, preprocess=False,
        config=config, device='cpu')
    port.data.augment.datasets(['synthetic'], config)
    shutil.copytree(root / 'port' / 'cache', root / 'jax' / 'cache')
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    ours_partition = port.partition.adaptation_partitions(
        'synthetic', 2, config)

    with pytest.MonkeyPatch.context() as patch:
        # One device of the test's virtual CPU mesh: batches of 2 do not
        # shard over eight
        for name, value in dict(
                NARROW, MESH_SHAPE={'data': 1},
                CACHE_DIR=root / 'jax' / 'cache', ASSETS_DIR=assets,
                AUGMENT_DIR=root / 'augmentations',
                RUNS_DIR=root / 'jax' / 'runs',
                RESULTS_DIR=root / 'jax' / 'results',
                EVAL_DIR=root / 'jax' / 'eval').items():
            patch.setattr(promonet_tpu, name, value)
        patch.setattr(
            promonet_tpu.synthesize.core._cached_model, 'cache', {},
            raising=False)
        promonet_tpu.data.preprocess.datasets(['synthetic'])
        theirs_partition = promonet_tpu.partition.adaptation_partitions(
            'synthetic', 2)
        params = jax.device_get(jax_core.create_state(
            jax.random.PRNGKey(0))['generator']['params'])
        base = root / 'jax' / 'base' / 'generator-00000001'
        promonet_tpu.utils.checkpoint.save(base, params, step=1)
        theirs = promonet_tpu.evaluate.datasets(
            ['synthetic'], checkpoint=base, adapt=True, max_stems=1)

    port_base = root / 'port' / 'base' / 'generator-00000001.pt'
    save(port_base, bridge.generator_state_dict(params), step=1)
    ours = port.evaluate.datasets(
        ['synthetic'], checkpoint=port_base, adapt=True, max_stems=1,
        config=config, device='cpu')
    yield root, config, (ours_partition, theirs_partition), ours, theirs
    drop_large_files(root)


def test_adaptation_partitions_match_jax(adapted):
    root, config, (ours, theirs), _, _ = adapted
    assert ours == theirs
    assert set(ours) == {'train-adapt-00', 'test-adapt-00'}
    assert json.loads((config.PARTITIONS_DIR / 'adaptation' /
                       'synthetic.json').read_text()) == json.loads((
        root / 'assets' / 'partitions' / 'adaptation' /
        'synthetic.json').read_text())


def test_adaptation_runs_lie_where_the_jax_runs_do(adapted):
    root, _, _, _, _ = adapted
    theirs = root / 'jax' / 'runs'
    ours = root / 'port' / 'runs'
    run = Path('promonet') / 'adapt' / 'synthetic' / '00'
    assert (theirs / run).is_dir() and (ours / run).is_dir()
    their_checkpoints = sorted(
        path.name for path in (theirs / run).iterdir()
        if path.name.startswith(('generator-', 'discriminator-')))
    our_checkpoints = sorted(
        path.name[:-len('.pt')] for path in (ours / run).iterdir()
        if path.suffix == '.pt')
    # From step 1 of the base, ADAPTATION_STEPS more: one step, saved at 2
    assert our_checkpoints == their_checkpoints == [
        'discriminator-00000002', 'generator-00000002']


def test_adaptation_results_have_the_jax_keys(adapted):
    root, config, _, ours, theirs = adapted
    ours, theirs = ours['synthetic'], theirs['synthetic']
    assert _keys(ours) == _keys(theirs)
    assert set(ours['speakers']) == {'00'}
    assert ours['num_samples'] == theirs['num_samples']
    assert set(ours['objective']) == {
        'reconstructed', 'shifted-141', 'stretched-141', 'scaled-141',
        'balance-141', 'loudness-141'}
    for name in ('results.json', '00.json'):
        assert (config.RESULTS_DIR / 'promonet' / 'synthetic' /
                name).exists()
    assert all(np.isfinite(value['ppg'])
               for value in ours['objective'].values())


def test_adapted_run_is_not_trained_again(adapted):
    """A speaker whose adaptation run has a checkpoint is evaluated with it"""
    root, config, _, _, _ = adapted
    run = config.RUNS_DIR / 'promonet' / 'adapt' / 'synthetic' / '00'
    before = sorted(path.name for path in run.iterdir())
    port.evaluate.datasets(
        ['synthetic'], adapt=True, max_stems=1,
        config=config.replace(RESULTS_DIR=root / 'again'), device='cpu')
    assert sorted(path.name for path in run.iterdir()) == before


def test_adapt_speaker_trains_a_run_of_its_own(adapted, tmp_path):
    root, config, _, _, _ = adapted
    files = sorted((config.CACHE_DIR / 'synthetic' / '0000').glob(
        '00000*-100.wav'))
    for i, file in enumerate(files + files[:1]):
        shutil.copy(file, tmp_path / f'recording-{i}.wav')
    config = config.replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        AUGMENT_DIR=tmp_path / 'augmentations', RUNS_DIR=tmp_path / 'runs',
        DEFAULT_EVALUATION_STEPS=1)
    directory = port.adapt.speaker(
        'newvoice', sorted(tmp_path.glob('recording-*.wav')),
        checkpoint=root / 'port' / 'base' / 'generator-00000001.pt',
        config=config, device='cpu')
    assert directory == tmp_path / 'runs' / 'newvoice'
    assert (directory / 'generator-00000002.pt').exists()
    cached = sorted(
        path.name for path in (tmp_path / 'cache' / 'newvoice' /
                               '0000').glob('*.wav'))
    assert len(cached) == 3 * 5 and cached[0].startswith('000000-100-l')
    assert (tmp_path / 'augmentations' / 'newvoice-pitch.json').exists()
    partition = port.load.partition('newvoice', False, config)
    assert set(partition) == {'train', 'valid', 'test'}


def test_normalize_gain_matches_jax():
    from promonet_tpu.data.download import core as download
    rng = np.random.default_rng(0)
    for peak in (0.05, 0.34, 0.5, 0.):
        audio = rng.uniform(-1, 1, (1, 100)).astype(np.float32)
        audio = audio * (peak / max(np.abs(audio).max(), 1e-9))
        np.testing.assert_array_equal(
            port.adapt.normalize_gain(audio), download.normalize_gain(audio))
