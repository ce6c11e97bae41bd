"""The port's device-resident training data (`data.resident`) and its
trainer path held against the JAX package's.

One corpus (2 speakers x 4 utterances x 0.5 s, augmented, preprocessed
with seeded extractors) made by the port; the JAX package reads it with
only its CACHE_DIR, ASSETS_DIR and AUGMENT_DIR pointed at it. At a
CHUNK_SIZE of 4096 (16 frames) every stem holds a chunk.

- `pack` equals the JAX package's `resident.pack` (`==`, and dtypes);
- `crops` of the rows and starts that the JAX package's `sample` draws
  from a key (re-derived here: split, randint, uniform, the floor
  formula) equals that `sample`'s batch;
- `sample` draws in range and again the same from the same seed;
- `to_device(..., rank, world=2)` holds the shards of the JAX package's
  `to_device` on a 2-device data mesh, padding included;
- `steps_per_dispatch` equals the JAX package's over a table of
  cadences;
- a narrow resident `train` of 2 steps in one dispatch on the CPU.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.train import core as jax_core

import promonet_tpu_torch as port
from promonet_tpu_torch.data import resident
from promonet_tpu_torch.train import core

from test_torch_train import NARROW, drop_large_files

jax_resident = importlib.import_module('promonet_tpu.data.resident')
CHUNK_SIZE = 4096
CHUNK_FRAMES = CHUNK_SIZE // 256


@pytest.fixture(scope='module', autouse=True)
def _quiet():
    """No TensorBoard writer"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(
            port.utils.log, '_tensorboard_writer', lambda directory: None)
        yield


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The port's configuration over the corpus, and the JAX package's
    directory settings for it"""
    root = tmp_path_factory.mktemp('resident')
    config = port.config.load().replace(
        **dict(NARROW, CHUNK_SIZE=CHUNK_SIZE),
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=root / 'assets' /
        'partitions', AUGMENT_DIR=root / 'augmentations',
        RUNS_DIR=root / 'runs', CHECKPOINTS_DIR=root / 'checkpoints',
        DEFAULT_EVALUATION_STEPS=1, NUM_WORKERS=2)
    port.data.synthetic.create(
        speakers=2, utterances=4, seconds=0.5, preprocess=False,
        config=config, device='cpu')
    port.data.augment.datasets(['synthetic'], config)
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    jax_dirs = dict(
        CACHE_DIR=config.CACHE_DIR, ASSETS_DIR=root / 'assets',
        AUGMENT_DIR=config.AUGMENT_DIR, CHUNK_SIZE=CHUNK_SIZE)
    return config, jax_dirs


@pytest.fixture(scope='module')
def packed(corpus):
    """(the port's pack, the JAX package's pack) of the train partition"""
    config, jax_dirs = corpus
    with pytest.MonkeyPatch.context() as patch:
        for name, value in jax_dirs.items():
            patch.setattr(promonet_tpu, name, value)
        theirs = jax_resident.pack('synthetic', 'train')
    return resident.pack('synthetic', 'train', config), theirs


def test_pack_equals_jax(corpus, packed):
    ours, theirs = packed
    assert list(ours) == list(theirs)
    # Every training item, augmented copies included, holds a chunk
    assert len(ours['lengths']) == len(
        port.data.Dataset('synthetic', 'train', corpus[0])) > 9
    for name, value in theirs.items():
        assert ours[name].dtype == value.dtype, name
        assert ours[name].shape == value.shape, name
        assert (ours[name] == value).all(), name
    assert ours['audio'].dtype == np.int16
    assert ours['loudness'].shape[1] == 8
    assert set(ours['spectral_balance_ratios']) != {1.}
    assert set(ours['loudness_ratios']) != {1.}


def test_pack_refuses_zero_shot(corpus):
    config, _ = corpus
    with pytest.raises(ValueError, match='RESIDENT_DATA'):
        resident.pack('synthetic', 'train', config.replace(ZERO_SHOT=True))


@pytest.mark.parametrize('seed', [0, 1])
def test_crops_equal_jax_sample(packed, seed):
    ours, theirs = packed
    key = jax.random.PRNGKey(seed)
    batch_size = 5
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'CHUNK_SIZE', CHUNK_SIZE)
        expected = jax.device_get(jax_resident.sample(
            {name: jnp.asarray(value) for name, value in theirs.items()},
            key, batch_size))

    # The draws of `sample`, re-derived from the key
    stem_key, start_key = jax.random.split(key)
    lengths = jnp.asarray(theirs['lengths'])
    rows = jax.random.randint(stem_key, (batch_size,), 0, len(lengths))
    max_start = (lengths[rows] - CHUNK_FRAMES).astype(jnp.float32)
    uniform = jax.random.uniform(start_key, (batch_size,))
    starts = jnp.floor(uniform * (max_start + 1.)).astype(jnp.int32)

    batch = resident.crops(
        resident.to_device(ours, 'cpu'), torch.from_numpy(np.array(rows)),
        torch.from_numpy(np.array(starts)), CHUNK_FRAMES)
    assert set(batch) == set(expected)
    for name, value in expected.items():
        np.testing.assert_array_equal(batch[name].numpy(), value, name)
    assert batch['audio'].dtype == torch.float32
    assert batch['audio'].shape == (batch_size, 1, CHUNK_SIZE)
    assert batch['speakers'].dtype == torch.int64


def test_sample_draws_in_range_and_reproducibly(corpus, packed):
    config, _ = corpus
    data = resident.to_device(packed[0], 'cpu')
    rows, starts = resident.draw(
        data, torch.Generator().manual_seed(3), 256, CHUNK_FRAMES)
    assert rows.min() >= 0 and rows.max() < len(data['lengths'])
    assert len(set(rows.tolist())) > 9
    assert (starts >= 0).all()
    assert (starts <= data['lengths'][rows] - CHUNK_FRAMES).all()
    assert starts.max() > 0

    first, second = (
        resident.sample(data, torch.Generator().manual_seed(7), 4, config)
        for _ in range(2))
    for name, value in first.items():
        torch.testing.assert_close(second[name], value, rtol=0, atol=0)
    assert first['audio'].shape == (4, 1, CHUNK_SIZE)

    # Each rank draws its part of the global batch from its own shard
    shard = resident.to_device(packed[0], 'cpu', rank=1, world=2)
    batch = resident.sample_sharded(
        shard, torch.Generator().manual_seed(7), 1, 2, 4, config)
    assert batch['audio'].shape == (2, 1, CHUNK_SIZE)
    with pytest.raises(ValueError, match='divide'):
        resident.sample_sharded(
            shard, torch.Generator(), 0, 3, 4, config)


def test_to_device_shards_like_jax(packed):
    ours, theirs = packed
    # An odd number of stems, so that the cycling pads one
    ours = {name: value[:7] for name, value in ours.items()}
    theirs = {name: value[:7] for name, value in theirs.items()}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ('data',))
    arrays = jax_resident.to_device(theirs, mesh)
    shards = [resident.to_device(ours, 'cpu', rank, 2) for rank in (0, 1)]
    for name, array in arrays.items():
        placed = sorted(array.addressable_shards, key=lambda s: s.device.id)
        assert len(placed) == 2
        for rank, shard in enumerate(placed):
            np.testing.assert_array_equal(
                shards[rank][name].numpy(), np.asarray(shard.data), name)
    assert len(shards[0]['lengths']) == len(shards[1]['lengths']) == 4
    # The padding is stem 0 again
    np.testing.assert_array_equal(shards[1]['audio'][-1], ours['audio'][0])


CADENCES = [
    # EVALUATION_INTERVAL, CHECKPOINT_INTERVAL, DISCRIMINATOR_START_STEP,
    # ADVERSARIAL_LOSS_START_STEP, total steps, STEPS_PER_DISPATCH
    (2500, 20000, 0, 0, 800000, None),
    (2500, 20000, 0, 0, 4, None),
    (2500, 20000, 0, 0, 6, None),
    (50000, 10000, 0, 0, 800000, None),
    (2500, 20000, 0, 0, None, None),
    (2500, 20000, 1000, 0, 800000, None),
    (100, 300, 30, 45, 900, None),
    (7, 11, 0, 0, 13, None),
    (2500, 20000, 0, 0, 4, 2),
    (50000, 10000, 0, 0, 800000, 50),
    (2500, 20000, 0, 0, 4, 0),
]


@pytest.mark.parametrize(
    'evaluation, checkpoint, discriminator, adversarial, total, configured',
    CADENCES)
def test_steps_per_dispatch_matches_jax(
        monkeypatch, evaluation, checkpoint, discriminator, adversarial,
        total, configured):
    settings = dict(
        EVALUATION_INTERVAL=evaluation, CHECKPOINT_INTERVAL=checkpoint,
        DISCRIMINATOR_START_STEP=discriminator,
        ADVERSARIAL_LOSS_START_STEP=adversarial,
        STEPS_PER_DISPATCH=configured)
    for name, value in settings.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    config = port.config.load().replace(**settings)
    assert core.steps_per_dispatch(total, config) == \
        jax_core.steps_per_dispatch(total)


def test_resident_data_resolves_as_jax_does():
    config = port.config.load()
    assert core.resident_data(config, 'cuda')
    assert not core.resident_data(config, 'cpu')
    assert not core.resident_data(
        config.replace(SPECTROGRAM_ONLY=True), 'cuda')
    assert not core.resident_data(config.replace(ZERO_SHOT=True), 'cuda')
    assert core.resident_data(config.replace(RESIDENT_DATA=True), 'cpu')
    assert not core.resident_data(
        config.replace(RESIDENT_DATA=False), 'cuda')
    # The JAX package's setting of the synthetic run is read
    assert port.config.load('configs/synthetic.py').STEPS_PER_DISPATCH == 50


def test_resident_run_takes_one_dispatch_of_two_steps(
        corpus, tmp_path, monkeypatch):
    config, _ = corpus
    config = config.replace(
        RESIDENT_DATA=True, STEPS_PER_DISPATCH=2, RUNS_DIR=tmp_path / 'runs')
    partitions = []
    original = core.data.loader

    def loader(dataset, partition, *args, **kwargs):
        partitions.append(partition)
        return original(dataset, partition, *args, **kwargs)

    monkeypatch.setattr(core.data, 'loader', loader)
    calls, steps = [], []
    original_step = core.train_step

    def train_step(state, batch, **kwargs):
        steps.append(sorted(batch))
        return original_step(state, batch, **kwargs)

    monkeypatch.setattr(core, 'train_step', train_step)
    directory = tmp_path / 'run'
    try:
        port.train(
            directory, 'synthetic', steps=2, config=config, device='cpu',
            callback=lambda step, metrics: calls.append(
                (step, float(metrics['loss/generator/total']))))
        # Only validation reads through the host loader
        assert partitions == ['valid']
        assert len(steps) == 2
        assert 'spectrograms' in steps[0] and 'stems' not in steps[0]
        assert [step for step, _ in calls] == [1]
        assert np.isfinite(calls[0][1])
        assert (directory / 'generator-00000002.pt').exists()
        assert port.utils.checkpoint.load(
            directory / 'generator-00000002.pt')['step'] == 2
        records = [json.loads(line) for line in (
            config.RUNS_DIR / 'notifications.jsonl').read_text().splitlines()]
        assert [(r['job'], r['status']) for r in records] == [
            ('train', 'started'), ('train', 'completed')]
        assert not (config.RUNS_DIR / 'trainer.pid').exists()
    finally:
        drop_large_files(tmp_path)
