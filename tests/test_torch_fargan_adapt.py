"""Speaker adaptation and adaptation-mode evaluation of a FARGAN
configuration, which need no code of their own.

configs/fargan.py at a narrow size (batch 2 of 6 frames, float32, one
adaptation step, one edit ratio) on a port corpus of one speaker x 4
utterances x 0.5 s with seeded extractors: `evaluate.datasets(adapt=True)`
fine-tunes a seeded FARGAN checkpoint on the speaker's train-adapt
partition (FARGAN's training route, its noise and its history) and scores
the test-adapt one in every condition; `adapt.speaker` trains a run of
its own from the same checkpoint; and `python -m promonet_tpu_torch.train
--config configs/fargan.py` trains on the same corpus.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import promonet_tpu_torch as port

from test_torch_train import drop_large_files

ROOT = Path(__file__).resolve().parent.parent
NARROW = dict(
    CHUNK_SIZE=1536, BATCH_SIZE=2, PRECISION='float32', STEPS=0,
    ADAPTATION_STEPS=1, EVALUATION_RATIOS=[1.414],
    DEFAULT_EVALUATION_STEPS=1)


@pytest.fixture(scope='module', autouse=True)
def _no_tensorboard():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            port.utils.log, '_tensorboard_writer', lambda directory: None)
        yield


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    yield
    drop_large_files(tmp_path)


@pytest.fixture(scope='module')
def adapted(tmp_path_factory):
    root = tmp_path_factory.mktemp('fargan-adapt')
    config = port.config.load(ROOT / 'configs' / 'fargan.py').replace(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=root / 'partitions',
        AUGMENT_DIR=root / 'augmentations', RUNS_DIR=root / 'runs',
        RESULTS_DIR=root / 'results', EVAL_DIR=root / 'eval',
        CHECKPOINTS_DIR=root / 'checkpoints', **NARROW)
    port.data.synthetic.create(
        speakers=1, utterances=4, seconds=0.5, preprocess=False,
        config=config, device='cpu')
    port.data.augment.datasets(['synthetic'], config)
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    port.partition.adaptation_partitions('synthetic', 2, config)
    base = root / 'base' / 'generator-00000001.pt'
    port.utils.checkpoint.save(base, port.models.init.seeded(
        port.models.Generator(config), 0).state_dict(), step=1)
    results = port.evaluate.datasets(
        ['synthetic'], checkpoint=base, adapt=True, max_stems=1,
        config=config, device='cpu')
    yield root, config, base, results['synthetic']
    drop_large_files(root)


def test_fargan_adapts_and_evaluates(adapted):
    root, config, _, results = adapted
    run = config.RUNS_DIR / 'fargan' / 'adapt' / 'synthetic' / '00'
    assert sorted(path.name for path in run.glob('*.pt')) == [
        'discriminator-00000002.pt', 'generator-00000002.pt']
    payload = port.utils.checkpoint.load(run / 'generator-00000002.pt')
    assert any(name.endswith('fwconv.dense.weight_v')
               for name in payload['trainable'])
    assert set(results['speakers']) == {'00'}
    assert set(results['objective']) == {
        'reconstructed', 'shifted-141', 'stretched-141', 'scaled-141',
        'balance-141', 'loudness-141'}
    for values in results['objective'].values():
        assert np.isfinite(values['ppg'])
        assert np.isfinite(values['loudness']['loudness'])
    wavs = list((config.EVAL_DIR / 'subjective').rglob('*.wav'))
    assert len(wavs) == 1 + 6


def test_fargan_adapt_speaker_trains_a_run_of_its_own(adapted, tmp_path):
    root, config, base, _ = adapted
    files = sorted((config.CACHE_DIR / 'synthetic' / '0000').glob(
        '00000*-100.wav'))
    for i, file in enumerate(files):
        shutil.copy(file, tmp_path / f'recording-{i}.wav')
    config = config.replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        AUGMENT_DIR=tmp_path / 'augmentations', RUNS_DIR=tmp_path / 'runs')
    directory = port.adapt.speaker(
        'newvoice', sorted(tmp_path.glob('recording-*.wav')),
        checkpoint=base, config=config, device='cpu')
    generator = port.load.generator(
        directory / 'generator-00000002.pt', config, 'cpu')
    assert isinstance(generator.backbone, port.models.fargan.FARGAN)
    before = port.load.generator(base, config, 'cpu')
    changed = [
        name for name, value in generator.state_dict().items()
        if not torch.equal(value, before.state_dict()[name])]
    assert any(name.startswith('backbone.subframe.') for name in changed)


def test_command_line_trains_fargan(adapted, tmp_path):
    """`python -m promonet_tpu_torch.train --config configs/fargan.py` on
    the CPU, narrowed by a second configuration file: one step, its
    checkpoints and metrics in RUNS_DIR / 'fargan'"""
    _, config, _, _ = adapted
    # A TensorBoard that does not import keeps TensorFlow out of the
    # process
    stub = tmp_path / 'stub' / 'tensorboard'
    stub.mkdir(parents=True)
    (stub / '__init__.py').write_text(
        "raise ImportError('TensorBoard is left out of this test')\n")
    narrow = tmp_path / 'narrow.py'
    narrow.write_text("MODULE = 'promonet_tpu_torch'\n" + ''.join(
        f'{name} = {value!r}\n' for name, value in dict(
            NARROW, STEPS=1, NUM_WORKERS=2,
            CACHE_DIR=str(config.CACHE_DIR),
            PARTITIONS_DIR=str(config.PARTITIONS_DIR),
            AUGMENT_DIR=str(config.AUGMENT_DIR),
            CHECKPOINTS_DIR=str(config.CHECKPOINTS_DIR),
            RUNS_DIR=str(tmp_path / 'runs')).items()))
    result = subprocess.run(
        [sys.executable, '-m', 'promonet_tpu_torch.train', '--dataset',
         'synthetic', '--config', str(ROOT / 'configs' / 'fargan.py'),
         str(narrow), '--gpu', '-1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PROMONET_TPU_TORCH_CONFIG='',
                 PYTHONPATH=os.pathsep.join(
                     [str(stub.parent)] + [
                         path for path in [os.environ.get('PYTHONPATH')]
                         if path])))
    assert result.returncode == 0, result.stderr[-3000:]
    run = tmp_path / 'runs' / 'fargan'
    assert {'fargan.py', 'narrow.py', 'generator-00000001.pt',
            'discriminator-00000001.pt', 'metrics.jsonl'} <= {
        path.name for path in run.iterdir()}
    payload = port.utils.checkpoint.load(run / 'generator-00000001.pt')
    assert any(name.endswith('skip_glu.dense.weight_g')
               for name in payload['trainable'])
