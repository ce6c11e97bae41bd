"""The port's training data path held against the JAX package's.

One corpus (3 speakers x 4 utterances x 0.5 s, made by the port) is
copied twice and augmented by each package; the ratio files and the
augmented wavs must be equal to the byte. The port's copy is then
preprocessed (seeded extractors on the CPU) and read by both packages'
`Dataset`: whole items, training crops drawn from the same seeds (at a
CHUNK_SIZE of 4096, a window of each utterance, and of 16384, longer
than every utterance, which reflect-pads), `collate`, the sampler's
batch order over epochs 0 to 2 and the loaders' batches, all equal. The
native wav decoder is built with g++ and held bit-equal to its plain
version.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import importlib

import promonet_tpu

# Modules by path: the JAX package's data namespace exports functions of
# the same names
jax_collate = importlib.import_module('promonet_tpu.data.collate')
jax_dataset = importlib.import_module('promonet_tpu.data.dataset')
jax_loader = importlib.import_module('promonet_tpu.data.loader')
jax_sampler = importlib.import_module('promonet_tpu.data.sampler')

import promonet_tpu_torch as port
from promonet_tpu_torch.data import native

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(speakers=3, utterances=4, seconds=0.5)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """(root, the port's config over its augmented, preprocessed copy, the
    JAX package's directory settings, the JAX-augmented copy)"""
    root = tmp_path_factory.mktemp('train_data')
    config = port.config.load().replace(
        CACHE_DIR=root / 'port' / 'cache',
        PARTITIONS_DIR=root / 'assets' / 'partitions',
        AUGMENT_DIR=root / 'port' / 'augmentations',
        CHECKPOINTS_DIR=root / 'checkpoints', RUNS_DIR=root / 'port' / 'runs')
    port.data.synthetic.create(
        **SHAPE, preprocess=False, config=config, device='cpu')
    shutil.copytree(root / 'port' / 'cache', root / 'jax' / 'cache')
    port.data.augment.datasets(['synthetic'], config)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'CACHE_DIR', root / 'jax' / 'cache')
        patch.setattr(
            promonet_tpu, 'AUGMENT_DIR', root / 'jax' / 'augmentations')
        # Its job log goes to RUNS_DIR
        patch.setattr(promonet_tpu, 'RUNS_DIR', root / 'jax' / 'runs')
        promonet_tpu.data.augment.datasets(['synthetic'])
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device='cpu')
    jax_dirs = dict(
        CACHE_DIR=config.CACHE_DIR, ASSETS_DIR=root / 'assets',
        AUGMENT_DIR=config.AUGMENT_DIR)
    return root, config, jax_dirs


@pytest.fixture
def jax_dirs(corpus, monkeypatch):
    _, _, dirs = corpus
    for name, value in dirs.items():
        monkeypatch.setattr(promonet_tpu, name, value)
    return dirs


def test_augmentation_matches_jax(corpus):
    root, _, _ = corpus
    for kind in ('pitch', 'loudness'):
        ours = root / 'port' / 'augmentations' / f'synthetic-{kind}.json'
        theirs = root / 'jax' / 'augmentations' / f'synthetic-{kind}.json'
        assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    ours = sorted((root / 'port' / 'cache').glob('*/*/*.wav'))
    theirs = sorted((root / 'jax' / 'cache').glob('*/*/*.wav'))
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert len(ours) == 3 * SHAPE['speakers'] * SHAPE['utterances']
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_augmentation_ratio_file_of_the_port_comes_first(corpus, tmp_path):
    _, config, _ = corpus
    dataset = port.data.dataset
    assert dataset.ratio_file('synthetic', 'pitch', config) == \
        config.AUGMENT_DIR / 'synthetic-pitch.json'
    shipped = dataset.ratio_file(
        'synthetic', 'pitch', config.replace(AUGMENT_DIR=tmp_path))
    assert shipped == config.ASSETS_DIR / 'augmentations' / \
        'synthetic-pitch.json'


def _assert_items_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if isinstance(value, str):
            assert ours[key] == value, key
        else:
            np.testing.assert_array_equal(
                np.asarray(ours[key]), np.asarray(value), err_msg=key)
            assert np.asarray(ours[key]).dtype == np.asarray(value).dtype, key


@pytest.mark.parametrize('partition', ['train', 'valid'])
def test_whole_items_match_jax(corpus, jax_dirs, partition):
    _, config, _ = corpus
    ours = port.data.Dataset('synthetic', partition, config)
    theirs = jax_dataset.Dataset('synthetic', partition)
    assert ours.stems == theirs.stems
    if partition == 'train':
        assert any('-p' in stem for stem in ours.stems)
    for index in range(len(theirs)):
        _assert_items_equal(ours[index], theirs[index])


@pytest.mark.parametrize('chunk_size', [4096, 16384])
def test_training_crops_match_jax(corpus, jax_dirs, chunk_size, monkeypatch):
    _, config, _ = corpus
    monkeypatch.setattr(promonet_tpu, 'CHUNK_SIZE', chunk_size)
    config = config.replace(CHUNK_SIZE=chunk_size)
    ours = port.data.Dataset('synthetic', 'train', config)
    theirs = jax_dataset.Dataset('synthetic', 'train')
    for index in range(len(theirs)):
        for epoch in range(2):
            seed = (config.RANDOM_SEED, epoch, index)
            mine = ours.load_item(index, np.random.default_rng(seed))
            _assert_items_equal(
                mine, theirs.load_item(index, np.random.default_rng(seed)))
            assert mine['audio'].shape == (1, chunk_size)
            assert mine['pitch'].shape == (chunk_size // 256,)


def test_collate_matches_jax(corpus, jax_dirs, monkeypatch):
    _, config, _ = corpus
    ours = port.data.Dataset('synthetic', 'train', config)
    theirs = jax_dataset.Dataset('synthetic', 'train')
    items = [theirs[index] for index in (0, 3, 5)]
    monkeypatch.setattr(promonet_tpu, 'CHUNK_SIZE', 4096)
    chunked = [
        theirs.load_item(index, np.random.default_rng(index))
        for index in (1, 2)]
    for batch, pad in ((items, True), (items, False), (chunked, False)):
        _assert_items_equal(
            port.data.collate(batch, pad, config),
            jax_collate.collate(batch, pad))
    assert port.data.collate(items, True, config)['pitch'].shape[-1] == 64


@pytest.mark.parametrize('partition', ['train', 'valid'])
def test_sampler_matches_jax(partition, monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'BATCH_SIZE', 4)
    config = port.config.load().replace(BATCH_SIZE=4)
    ours = port.data.Sampler(30, partition, config)
    theirs = jax_sampler.Sampler(30, partition)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
        assert len(ours) == len(theirs)
    assert len(port.data.Sampler(3, 'train', config)) == 0
    assert list(port.data.Sampler(3, 'train', config)) == []


def test_loaders_match_jax(corpus, jax_dirs, monkeypatch):
    _, config, _ = corpus
    monkeypatch.setattr(promonet_tpu, 'BATCH_SIZE', 4)
    monkeypatch.setattr(promonet_tpu, 'CHUNK_SIZE', 4096)
    config = config.replace(BATCH_SIZE=4, CHUNK_SIZE=4096, NUM_WORKERS=3)
    for partition in ('train', 'valid'):
        ours = port.data.loader('synthetic', partition, config)
        theirs = jax_loader.loader('synthetic', partition)
        for epoch in (0, 1):
            ours.sampler.set_epoch(epoch)
            theirs.sampler.set_epoch(epoch)
            batches = list(theirs)
            mine = list(ours)
            assert len(mine) == len(batches) == len(theirs)
            for a, b in zip(mine, batches):
                _assert_items_equal(a, b)


def test_loader_stops_early_and_raises_what_a_worker_raised(corpus):
    _, config, _ = corpus
    config = config.replace(BATCH_SIZE=1, CHUNK_SIZE=4096, NUM_WORKERS=2)
    loader = port.data.loader('synthetic', 'train', config)
    for _ in loader:
        break
    loader.dataset.stems[3] = 'missing/000000-100'
    with pytest.raises(FileNotFoundError):
        list(loader)


def test_native_decoder_is_bit_equal_to_the_plain_reader(corpus):
    _, config, _ = corpus
    wavs = sorted(config.CACHE_DIR.glob('*/*/*.wav'))[:4]
    for wav in wavs[:3]:
        total = native.wav_frames(wav)
        assert total == port.utils.audio.load(wav)[0].shape[-1]
        # Windows inside the file and over either end
        for start, count in ((0, 4096), (1000, 2048), (total - 100, 512),
                             (-64, 256), (total - 4096, 4096)):
            np.testing.assert_array_equal(
                native.wav_chunk(wav, start, count),
                native.wav_chunk_plain(wav, start, count))
    starts = [0, 77, 1024, 3000]
    batch = native.wav_batch(wavs, starts, 4096, threads=2)
    for row, wav, start in zip(batch, wavs, starts):
        np.testing.assert_array_equal(
            row, native.wav_chunk_plain(wav, start, 4096))
    built = list((ROOT / 'build' / 'native').glob('promonet_io-*.so'))
    assert built and not list(
        (ROOT / 'promonet_tpu_torch' / 'csrc').glob('*.so'))


def test_native_crops_equal_the_plain_crops(corpus):
    _, config, _ = corpus
    config = config.replace(CHUNK_SIZE=4096)
    plain = port.data.Dataset('synthetic', 'train', config)
    fast = port.data.Dataset('synthetic', 'train', config, native=True)
    for index in range(len(plain)):
        seed = np.random.default_rng((1, index))
        _assert_items_equal(
            fast.load_item(index, seed),
            plain.load_item(index, np.random.default_rng((1, index))))
