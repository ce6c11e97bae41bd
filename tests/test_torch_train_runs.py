"""The port's training runs: their files, checkpoints, resumption, the
command line, and what does not train.

A port corpus (2 speakers x 4 utterances x 0.5 s, augmented, with seeded
extractors) and the narrow configuration of `test_torch_train.py`,
trained on the CPU for a few steps, and resumed from the JAX trainer's
checkpoints in the run directory. TensorBoard is left out (its import
brings TensorFlow into the process where it is installed, seconds for
nothing these tests read); `test_log_writes_tensorboard_where_it_imports`
holds that path with a stand-in writer.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import promonet_tpu_torch as port
from promonet_tpu_torch.train import core

from test_torch_train import NARROW, _batch, _config, drop_large_files

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module', autouse=True)
def _quiet():
    """No TensorBoard writer"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            port.utils.log, '_tensorboard_writer', lambda directory: None)
        yield


def test_log_writes_tensorboard_where_it_imports(tmp_path, monkeypatch):
    calls = []

    class Writer:
        def add_scalar(self, *args):
            calls.append(('scalar',) + args)

        def add_audio(self, name, audio, step, rate):
            calls.append(('audio', name, audio.shape, step, rate))

        def flush(self):
            calls.append(('flush',))

    monkeypatch.setattr(
        port.utils.log, '_tensorboard_writer', lambda directory: Writer())
    port.utils.log.update(
        tmp_path, 3, scalars={'loss': 1.5},
        audio={'audio/x': np.zeros((1, 10), np.float32)}, sample_rate=22050)
    assert calls == [('scalar', 'loss', 1.5, 3),
                     ('audio', 'audio/x', (10, 1), 3, 22050), ('flush',)]
    record = json.loads((tmp_path / 'metrics.jsonl').read_text())
    assert record['step'] == 3 and record['loss'] == 1.5


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    yield
    drop_large_files(tmp_path)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A port corpus of 2 speakers x 4 utterances x 0.5 s, augmented, with
    seeded extractors, and its configuration"""
    root = tmp_path_factory.mktemp('train')
    config = _config(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=root / 'partitions',
        AUGMENT_DIR=root / 'augmentations', RUNS_DIR=root / 'runs',
        CHECKPOINTS_DIR=root / 'checkpoints', DEFAULT_EVALUATION_STEPS=1,
        NUM_WORKERS=2)
    port.data.synthetic.create(
        speakers=2, utterances=4, seconds=0.5, preprocess=False,
        config=config, device='cpu')
    port.data.augment.datasets(['synthetic'], config)
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    return config


def test_train_writes_its_run_and_resumes(corpus, tmp_path):
    directory = tmp_path / 'run'
    losses = []
    state = port.train(
        directory, 'synthetic', steps=2, config=corpus, device='cpu',
        callback=lambda step, metrics: losses.append(
            (step, float(metrics['loss/generator/total']))))
    assert [step for step, _ in losses] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in losses)
    names = sorted(path.name for path in directory.iterdir())
    assert {'generator-00000002.pt', 'discriminator-00000002.pt',
            'metrics.jsonl'} <= set(names)
    records = [json.loads(line) for line in
               (directory / 'metrics.jsonl').read_text().splitlines()]
    assert records[0]['step'] == 0
    assert 'loss/generator/mels' in records[0]
    assert 'validation/mels' in records[1] and 'validation/pitch' in records[1]
    keys = port.utils.checkpoint.top_level_keys(
        directory / 'generator-00000002.pt')
    assert keys == {'params', 'step', 'epoch', 'trainable', 'optimizer'}

    # The effective weights serve synthesis as they are
    generator = port.load.generator(
        directory / 'generator-00000002.pt', corpus, 'cpu')
    for name, value in state.effective().items():
        torch.testing.assert_close(
            generator.state_dict()[name], value.detach(), rtol=0, atol=0)

    # Resume: a checkpoint cut short is skipped for the newest whole one
    (directory / 'generator-00000009.pt').write_bytes(b'PK\x03\x04 cut')
    losses.clear()
    port.train(directory, 'synthetic', steps=4, config=corpus, device='cpu',
               callback=lambda step, metrics: losses.append(step))
    assert losses == [2, 3]
    payload = port.utils.checkpoint.load(directory / 'generator-00000004.pt')
    assert payload['step'] == 4 and payload['optimizer']['step'] == 4
    discriminator = port.utils.checkpoint.load(
        directory / 'discriminator-00000004.pt')
    assert discriminator['optimizer']['step'] == 4


def test_train_resumes_from_a_jax_checkpoint_in_its_directory(
        corpus, tmp_path):
    """A run directory holding the JAX trainer's generator and
    discriminator checkpoints (orbax directories) resumes from them, and
    the port's own checkpoint pruning leaves them"""
    from promonet_tpu.train import core as jax_core

    from test_torch_train import _jax_steps

    states, _ = _jax_steps('float32', 0)
    directory = tmp_path / 'run'
    jax_core.save_checkpoint(directory, states[0], 5, 1)
    assert port.utils.checkpoint.latest_path(directory) == \
        directory / 'generator-00000005'
    steps = []
    port.train(directory, 'synthetic', steps=6, config=corpus, device='cpu',
               callback=lambda step, metrics: steps.append(step))
    assert steps == [5]
    payload = port.utils.checkpoint.load(directory / 'generator-00000006.pt')
    assert payload['step'] == 6 and payload['optimizer']['step'] == 1
    assert port.utils.checkpoint.latest_path(directory) == \
        directory / 'generator-00000006.pt'
    assert all(port.utils.checkpoint.is_orbax(directory / name) for name in (
        'generator-00000005', 'discriminator-00000005'))


def test_spectrogram_only_run_validates_its_mels(corpus, tmp_path):
    """The spectrogram-only generator's validation scores its masked mel
    loss alone, as the JAX package's does. Its input is the validation
    item's spectrogram zero-padded to the bucket, whose log-mels are
    -inf there, so the audio and the loss are NaN, as in the JAX package
    (ROADMAP.md §3); the training step's chunks are not padded and its
    losses are finite"""
    port.train(tmp_path, 'synthetic', steps=1,
               config=corpus.replace(SPECTROGRAM_ONLY=True), device='cpu')
    records = [json.loads(line) for line in
               (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert np.isfinite(records[0]['loss/generator/total'])
    assert [name for name in records[1] if name.startswith('validation/')
            ] == ['validation/mels']
    assert np.isnan(records[1]['validation/mels'])
    assert type(port.load.generator(
        tmp_path / 'generator-00000001.pt',
        corpus.replace(SPECTROGRAM_ONLY=True), 'cpu')).__name__ == \
        'MelGenerator'


def test_undersized_training_partition_raises(corpus, tmp_path):
    with pytest.raises(ValueError, match='fewer than one batch'):
        port.train(tmp_path, 'synthetic', steps=1,
                   config=corpus.replace(BATCH_SIZE=1000), device='cpu')


def test_fargan_does_not_train_yet(corpus, tmp_path):
    """FARGAN trains now (the name predates its training route): a run of
    configs/fargan.py's losses at the corpus's narrow size takes two steps,
    validates with the item's own first samples as history, and resumes;
    its generator's training route runs on a batch"""
    config = corpus.replace(
        MODEL='fargan', MEL_LOSS=False, SPECTRAL_CONVERGENCE_LOSS=True,
        CHUNK_SIZE=1536, ADVERSARIAL_LOSS_START_STEP=1)
    directory = tmp_path / 'run'
    losses = []
    for steps in (2, 3):
        port.train(
            directory, 'synthetic', steps=steps, config=config, device='cpu',
            callback=lambda step, metrics: losses.append((step, {
                name: float(value) for name, value in metrics.items()})))
    assert [step for step, _ in losses] == [0, 1, 2]
    assert all(np.isfinite(value) for _, metrics in losses
               for value in metrics.values())
    # Adversarial terms from step 1, no mel loss
    assert 'loss/generator/feature-matching' not in losses[0][1]
    assert 'loss/generator/feature-matching' in losses[1][1]
    assert 'loss/generator/spectral-convergence' in losses[0][1]
    assert not any('mels' in name for name in losses[0][1]
                   if name.startswith('loss/'))
    payload = port.utils.checkpoint.load(directory / 'generator-00000003.pt')
    assert payload['step'] == 3 and payload['optimizer']['step'] == 3
    assert any(name.endswith('fwconv.dense.weight_v')
               for name in payload['trainable'])
    records = [json.loads(line) for line in
               (directory / 'metrics.jsonl').read_text().splitlines()]
    assert np.isfinite(records[1]['validation/mels'])
    generator = port.load.generator(
        directory / 'generator-00000003.pt', config, 'cpu')
    batch = core.to_device(_batch(0), 'cpu')
    audio = generator(
        *core.generator_args(batch, config), train=True,
        previous_samples=core.previous_samples_of(batch, config))
    assert audio.shape == (2, 1, 8 * 256) and audio.requires_grad


def test_prune_keeps_the_newest_and_the_intervals(tmp_path):
    for step in (1, 2, 3, 4, 5, 20000, 40000, 40001):
        for prefix in ('generator', 'discriminator'):
            (tmp_path / f'{prefix}-{step:08d}.pt').write_bytes(b'')
    (tmp_path / 'metrics.jsonl').write_text('')
    port.utils.checkpoint.prune(tmp_path)
    kept = sorted(path.name for path in tmp_path.iterdir())
    # The newest three are 20000, 40000 and 40001; of the rest, no
    # multiple of 20000 is left
    assert kept == sorted(
        [f'{prefix}-{step:08d}.pt'
         for prefix in ('generator', 'discriminator')
         for step in (20000, 40000, 40001)] + ['metrics.jsonl'])
    (tmp_path / 'generator-00000001.pt').write_bytes(b'')
    port.utils.checkpoint.prune(tmp_path, keep_latest=1)
    assert sorted(path.name for path in tmp_path.glob('generator-*')) == [
        'generator-00020000.pt', 'generator-00040000.pt',
        'generator-00040001.pt']


def test_params_only_checkpoint_warm_starts(tmp_path):
    """A checkpoint of effective weights (the converted release's format)
    gives v = weight, g = its norm: the same generator output"""
    config = _config()
    generator = port.models.init.seeded(port.models.Generator(config), 5)
    file = tmp_path / 'generator-00000007.pt'
    port.utils.checkpoint.save(file, generator.state_dict(), step=7)
    assert port.utils.checkpoint.top_level_keys(file) == {
        'params', 'step', 'epoch'}
    state = core.create_state(config, 'cpu')
    assert core.load_checkpoint(state, file) == (7, 0)
    batch = core.to_device(_batch(0), torch.device('cpu'))
    with torch.no_grad():
        expected = generator(*core.generator_args(batch, config))
        warm = torch.func.functional_call(
            state.generator, state.effective(),
            core.generator_args(batch, config), {'train': True})
    np.testing.assert_allclose(
        warm.numpy(), expected.numpy(), rtol=0, atol=1e-6)
    assert state.generator_optimizer.state == {}


def test_command_line_trains_into_the_port_runs(corpus, tmp_path):
    # A TensorBoard that does not import keeps TensorFlow out of the
    # process, as the fixture does in this one
    stub = tmp_path / 'stub' / 'tensorboard'
    stub.mkdir(parents=True)
    (stub / '__init__.py').write_text(
        "raise ImportError('TensorBoard is left out of this test')\n")
    config_file = tmp_path / 'narrow.py'
    config_file.write_text(
        "MODULE = 'promonet_tpu_torch'\nCONFIG = 'narrow'\n" + ''.join(
            f'{name} = {value!r}\n' for name, value in dict(
                NARROW, CACHE_DIR=str(corpus.CACHE_DIR),
                PARTITIONS_DIR=str(corpus.PARTITIONS_DIR),
                AUGMENT_DIR=str(corpus.AUGMENT_DIR),
                CHECKPOINTS_DIR=str(corpus.CHECKPOINTS_DIR),
                RUNS_DIR=str(tmp_path / 'runs'), STEPS=1,
                DEFAULT_EVALUATION_STEPS=1, NUM_WORKERS=2).items()))
    result = subprocess.run(
        [sys.executable, '-m', 'promonet_tpu_torch.train', '--dataset',
         'synthetic', '--config', str(config_file), '--gpu', '-1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PROMONET_TPU_TORCH_CONFIG='',
                 PYTHONPATH=os.pathsep.join(
                     [str(stub.parent)] + [
                         path for path in [os.environ.get('PYTHONPATH')]
                         if path])))
    assert result.returncode == 0, result.stderr[-3000:]
    run = tmp_path / 'runs' / 'narrow'
    assert {'narrow.py', 'generator-00000001.pt',
            'discriminator-00000001.pt', 'metrics.jsonl'} <= {
        path.name for path in run.iterdir()}
