"""The bridge against the repo's real checkpoints.

Under the `runs/promonet/synthetic.py` configuration on both sides (24
speakers, the synthetic corpus's pitch-bin statistics), the release
generator and the shipped pitch and PPG checkpoints are restored on the
CPU with the JAX package's own loader, carried over, and every leaf must
map onto a port parameter of the same shape with none left over. Then
the models run in float32 on both sides at full width. The run directory
runs/promonet/release resolves to the release generator for
`load.generator` (given, or as the default run), the synthesize command
line and the adaptation lookup, as the JAX package's lookup resolves it;
`latest_path` takes either package's checkpoints and `prune` deletes the
port's files only.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.preprocess import pitch as jax_pitch
from promonet_tpu.preprocess import ppg as jax_ppg
from promonet_tpu.utils import checkpoint

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge

CONFIG = 'runs/promonet/synthetic.py'
GENERATOR = 'runs/promonet/release/generator-00155000'
RUN = 'runs/promonet/release'
ROOT = Path(__file__).resolve().parent.parent
PITCH = 'promonet_tpu/assets/checkpoints/pitch'
PPG = 'promonet_tpu/assets/checkpoints/ppg'


@pytest.fixture
def synthetic(monkeypatch):
    """The synthetic run's configuration, applied to both packages"""
    spec = importlib.util.spec_from_file_location('synthetic', CONFIG)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = port.config.load(CONFIG)
    for name in dir(module):
        if name.isupper() and name != 'MODULE':
            monkeypatch.setattr(promonet_tpu, name, getattr(module, name))
    monkeypatch.setattr(promonet_tpu, 'NUM_SPEAKERS', config.NUM_SPEAKERS)
    return config


@pytest.fixture(scope='module')
def generator_params():
    return jax.device_get(checkpoint.load(GENERATOR)['params'])


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_release_checkpoints_map_every_leaf(synthetic, generator_params):
    assert synthetic.NUM_SPEAKERS == 24
    generator = port.models.Generator(synthetic)
    state = bridge.generator_state_dict(generator_params)
    generator.load_state_dict(state, strict=True)
    # Weight norm folds (v, g) into one weight: each of the twelve
    # blocks turns 6 * 3 leaves into 2 tensors, each of the four
    # transposed convs 3 leaves into 2
    assert _leaf_count(generator_params) == \
        len(state) + 12 * (6 * 3 - 2) + 4 * (3 - 2)
    for name, path in (('pitch', PITCH), ('ppg', PPG)):
        params = jax.device_get(checkpoint.load(path)['params'])
        model = (port.preprocess.PitchCNN() if name == 'pitch'
                 else port.preprocess.PPGEncoder())
        state = getattr(bridge, f'{name}_state_dict')(params)
        model.load_state_dict(state, strict=True)
        assert _leaf_count(params) == len(state)


def test_release_pitch_and_ppg_match_jax():
    frames = np.random.default_rng(0).standard_normal(
        (4, 1024)).astype(np.float32)
    model = port.preprocess.PitchCNN()
    params = jax.device_get(checkpoint.load(PITCH)['params'])
    model.load_state_dict(bridge.pitch_state_dict(params))
    theirs = np.asarray(jax_pitch.PitchCNN.Model().apply(
        params, jnp.asarray(frames)))
    with torch.no_grad():
        ours = model(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())

    mels = np.random.default_rng(1).standard_normal(
        (1, 40, 80)).astype(np.float32) - 4
    model = port.preprocess.PPGEncoder()
    params = jax.device_get(checkpoint.load(PPG)['params'])
    model.load_state_dict(bridge.ppg_state_dict(params))
    theirs = np.asarray(jax_ppg.PPGEncoder(num_phonemes=40).apply(
        params, jnp.asarray(mels)))
    with torch.no_grad():
        ours = model(torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


def test_release_generator_matches_jax(synthetic, generator_params):
    """Full-width float32 forward on 64 frames"""
    frames = 64
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((1, 40, frames)) * 2
    inputs = (
        rng.uniform(-100, 20, (1, 513, frames)).astype(np.float32),
        rng.uniform(80, 300, (1, frames)).astype(np.float32),
        rng.uniform(0, 1, (1, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
            np.float32),
        np.array([3], np.int32),
        np.ones(1, np.float32),
        np.ones(1, np.float32))
    jax_model = promonet_tpu.models.Generator.create(dtype=jnp.float32)
    theirs = np.asarray(jax.jit(jax_model.apply)(
        generator_params, *map(jnp.asarray, inputs)))

    generator = port.models.Generator(synthetic.replace(PRECISION='float32'))
    generator.load_state_dict(bridge.generator_state_dict(generator_params))
    with torch.no_grad():
        ours = generator(
            *map(torch.from_numpy, inputs[:4]),
            torch.from_numpy(inputs[4]).long(),
            *map(torch.from_numpy, inputs[5:])).numpy()
    assert ours.shape == theirs.shape == (1, 1, frames * 256)
    np.testing.assert_allclose(
        ours, theirs, rtol=0, atol=1e-4 * np.abs(theirs).max())


###############################################################################
# JAX run directories
###############################################################################


def _state(generator):
    return {name: value.clone() for name, value in
            generator.state_dict().items()}


def test_a_jax_run_directory_loads_its_newest_generator(tmp_path):
    """`load.generator` of runs/promonet/release, given or as the default
    run under RUNS_DIR, is the generator of generator-00155000, which the
    JAX package's lookup resolves too"""
    assert port.utils.checkpoint.latest_path(RUN) == Path(GENERATOR) == \
        checkpoint.latest_path(RUN)
    config = port.config.load(CONFIG).replace(
        RUNS_DIR=tmp_path, CHECKPOINTS_DIR=tmp_path / 'checkpoints')
    expected = _state(port.load.generator(GENERATOR, config, device='cpu'))
    os.symlink(ROOT / RUN, tmp_path / config.CONFIG)
    for source in (RUN, None):
        state = port.load.generator(source, config, device='cpu').state_dict()
        assert set(state) == set(expected)
        for name, value in expected.items():
            assert torch.equal(state[name], value), (source, name)


def test_a_default_jax_checkpoint_of_another_model_is_passed_over(
        tmp_path, capsys):
    """The default run's newest checkpoint is an orbax directory that is
    no generator (the shipped pitch CNN): seeded weights, with a notice,
    as for a port checkpoint that does not fit"""
    config = port.config.load(CONFIG).replace(RUNS_DIR=tmp_path)
    (tmp_path / config.CONFIG).mkdir()
    os.symlink(ROOT / PITCH, tmp_path / config.CONFIG / 'generator-00000001')
    generator = port.load.generator(None, config, device='cpu')
    assert 'does not match the active configuration' in \
        capsys.readouterr().err
    seeded = port.models.init.seeded(port.models.Generator(config), 0)
    for name, value in seeded.state_dict().items():
        assert torch.equal(generator.state_dict()[name], value), name


def test_latest_path_takes_either_packages_checkpoints(tmp_path):
    """The newest readable of the port's `.pt` files and the JAX
    package's orbax directories, the port's file at an equal step; `prune`
    counts and deletes the port's files only"""
    latest = port.utils.checkpoint.latest_path
    save = port.utils.checkpoint.save
    os.symlink(ROOT / GENERATOR, tmp_path / 'generator-00155000')
    save(tmp_path / 'generator-00000010.pt', {'w': torch.zeros(1)}, step=10)
    assert latest(tmp_path) == tmp_path / 'generator-00155000'
    save(tmp_path / 'generator-00155000.pt', {'w': torch.ones(1)},
         step=155000)
    assert latest(tmp_path) == tmp_path / 'generator-00155000.pt'
    # An orbax directory cut short, and a directory that is no checkpoint
    cut = tmp_path / 'generator-00200000'
    cut.mkdir()
    (cut / '_CHECKPOINT_METADATA').write_text('{}')
    (tmp_path / 'generator-00300000').mkdir()
    assert latest(tmp_path) == tmp_path / 'generator-00155000.pt'
    assert latest(tmp_path, 'discriminator-*') is None

    for step in (1, 2, 3):
        save(tmp_path / f'generator-{step:08d}.pt', {}, step=step)
    port.utils.checkpoint.prune(tmp_path, keep_latest=1)
    assert sorted(path.name for path in tmp_path.iterdir()) == [
        'generator-00155000', 'generator-00155000.pt', 'generator-00200000',
        'generator-00300000']
    assert port.utils.checkpoint.is_orbax(tmp_path / 'generator-00155000')


def test_adaptation_reuses_a_jax_checkpoint(tmp_path, monkeypatch):
    """An adaptation run directory that holds a JAX checkpoint is not
    trained again"""
    config = port.config.load(CONFIG).replace(RUNS_DIR=tmp_path)
    directory = tmp_path / config.CONFIG / 'adapt' / 'daps' / '0003'
    directory.mkdir(parents=True)
    os.symlink(ROOT / GENERATOR, directory / 'generator-00155000')

    def train(*args, **kwargs):
        raise AssertionError('trained again')

    monkeypatch.setattr(sys.modules['promonet_tpu_torch.train'], 'train',
                        train)
    assert port.evaluate.core._adapt_speaker(
        'daps', '0003', GENERATOR, config, 'cpu') == \
        directory / 'generator-00155000'


def test_synthesize_cli_takes_a_jax_run_directory(tmp_path):
    frames = 16
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((40, frames))
    features = {
        'loudness': rng.uniform(-60, 0, (513, frames)),
        'pitch': rng.uniform(100, 250, (1, frames)),
        'periodicity': rng.uniform(0, 1, (1, frames)),
        'ppg': np.exp(logits) / np.exp(logits).sum(0, keepdims=True)}
    arguments = ['--checkpoint', RUN, '--config', CONFIG, '--speakers', '3',
                 '--gpu', '-1', '--output_files', str(tmp_path / 'a.wav')]
    for name, value in features.items():
        np.save(tmp_path / f'a-{name}.npy', value.astype(np.float32))
        arguments += [f'--{name}_files', str(tmp_path / f'a-{name}.npy')]
    result = subprocess.run(
        [sys.executable, '-m', 'promonet_tpu_torch.synthesize', *arguments],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert result.returncode == 0, result.stdout + result.stderr
    audio = port.load.audio(tmp_path / 'a.wav')
    assert audio.shape == (1, frames * 256)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
