"""The port's checkpoint format, its model loaders, the converter and the
three command-line entry points.

The CLIs run as `python -m promonet_tpu_torch.<stage>` in a subprocess on
the CPU (`--gpu -1`), with a `--config` file that points the loaders at a
directory of seeded checkpoints and narrows the generator. What they
write must carry the names of the port's `from_files_to_files` (the JAX
package's) and equal what that function writes in this process from the
same files and weights: both run the same float32 CPU code on the same
inputs, so arrays and wav files are held equal, not close. `--help` and
the refusals run the modules' main code in this process.
"""
import importlib.util
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from promonet_tpu.utils import checkpoint as jax_checkpoint

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.utils import checkpoint

ROOT = Path(__file__).resolve().parent.parent
SAMPLE_RATE = 22050

# A narrow float32 generator: initial width 16, four Blocks
NARROW = dict(HIFIGAN_UPSAMPLE_INITIAL_SIZE=16,
              HIFIGAN_RESBLOCK_KERNEL_SIZES=[3],
              HIFIGAN_RESBLOCK_DILATION_SIZES=[[1, 3, 5]],
              PRECISION='float32')


def _harmonic_audio(seconds, base=180.):
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    pitch = base + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def _names(directory):
    return sorted(path.name for path in Path(directory).iterdir())


def _assert_same_files(ours, theirs):
    assert _names(ours) == _names(theirs)
    for name in _names(ours):
        if name.endswith('.npy'):
            np.testing.assert_array_equal(
                np.load(Path(ours) / name), np.load(Path(theirs) / name))
        else:
            assert (Path(ours) / name).read_bytes() == \
                (Path(theirs) / name).read_bytes(), name


def _state(module, seed):
    return port.models.init.seeded(module, seed).state_dict()


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """Seeded checkpoints in the port's format, and a --config file that
    points the loaders at them and narrows the generator

    Returns (config file, its `config.Config`, generator checkpoint).
    """
    directory = tmp_path_factory.mktemp('weights')
    checkpoint.save(directory / 'pitch-00000001.pt',
                    _state(port.preprocess.PitchCNN(), 1), step=1,
                    voicing_threshold=0.3)
    checkpoint.save(directory / 'ppg-00000002.pt',
                    _state(port.preprocess.PPGEncoder(), 2), step=2)
    checkpoint.save(directory / 'speaker-00000003.pt',
                    _state(port.preprocess.SpeakerEncoder(), 3), step=3)
    file = directory / 'narrow.py'
    file.write_text(
        "MODULE = 'promonet_tpu_torch'\n"
        f"CHECKPOINTS_DIR = {str(directory)!r}\n" +
        ''.join(f'{name} = {value!r}\n' for name, value in NARROW.items()))
    config = port.config.load(file)
    generator = directory / 'generator-00000004.pt'
    checkpoint.save(
        generator, _state(port.models.Generator(config), 4), step=4)
    return file, config, generator


def _cli(stage, *arguments):
    """Run `python -m promonet_tpu_torch.<stage>` on the CPU"""
    result = subprocess.run(
        [sys.executable, '-m', f'promonet_tpu_torch.{stage}', *map(
            str, arguments), '--gpu', '-1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    return result


def _main(stage, arguments, monkeypatch):
    """Run the stage's `__main__` in this process with `arguments`"""
    monkeypatch.setattr(sys, 'argv', [f'{stage}/__main__.py', *arguments])
    runpy.run_module(f'promonet_tpu_torch.{stage}', run_name='__main__')


###############################################################################
# Checkpoints
###############################################################################


def test_checkpoint_round_trip(tmp_path):
    state = {'weight': torch.randn(3, 4), 'bias': torch.arange(3.)}
    path = tmp_path / 'run' / 'generator-00000012.pt'
    checkpoint.save(path, state, step=12, epoch=2, voicing_threshold=0.25)
    assert _names(tmp_path / 'run') == ['generator-00000012.pt']
    payload = checkpoint.load(path)
    assert set(payload) == {'params', 'step', 'epoch', 'voicing_threshold'}
    assert (payload['step'], payload['epoch']) == (12, 2)
    assert payload['voicing_threshold'] == 0.25
    for name, value in state.items():
        assert torch.equal(payload['params'][name], value)
    # Plain torch reads it without unpickling code
    assert torch.equal(
        torch.load(path, weights_only=True)['params']['weight'],
        state['weight'])
    assert checkpoint.load(path, map_location='meta')['params'][
        'bias'].device.type == 'meta'


def test_latest_path_skips_an_unreadable_newest(tmp_path):
    assert checkpoint.latest_path(tmp_path / 'missing') is None
    assert checkpoint.latest_path(tmp_path) is None
    for step in (5, 20, 30):
        checkpoint.save(tmp_path / f'generator-{step:08d}.pt',
                        {'w': torch.full((100,), float(step))}, step=step)
    checkpoint.save(tmp_path / 'pitch-00000099.pt', {'w': torch.ones(1)})
    (tmp_path / 'generator-00000040.pt.1234.tmp').write_bytes(b'partial')
    assert checkpoint.latest_path(tmp_path).name == 'generator-00000030.pt'
    # A write cut short
    newest = tmp_path / 'generator-00000030.pt'
    newest.write_bytes(newest.read_bytes()[:200])
    assert not checkpoint.readable(newest)
    assert checkpoint.latest_path(tmp_path).name == 'generator-00000020.pt'
    assert checkpoint.latest_path(tmp_path, 'pitch-*').name == \
        'pitch-00000099.pt'


def test_generator_loader_resolves_as_jax_does(weights, tmp_path, capsys):
    _, narrow, file = weights
    config = narrow.replace(RUNS_DIR=tmp_path, CONFIG='run')
    saved = checkpoint.load(file)['params']
    seeded = _state(port.models.Generator(config), 0)

    def same(generator, state):
        return all(torch.equal(generator.state_dict()[name], value)
                   for name, value in state.items())

    # No checkpoint anywhere: seeded weights, with a notice
    generator = port.load.generator(config=config, device='cpu')
    assert same(generator, seeded) and not generator.training
    assert 'using random init' in capsys.readouterr().err
    # A file, a run directory, the configured default
    assert same(port.load.generator(file, config, 'cpu'), saved)
    assert same(port.load.generator(file.parent, config, 'cpu'), saved)
    assert same(port.load.generator(
        config=config.replace(DEFAULT_CHECKPOINT=file), device='cpu'), saved)
    with pytest.raises(FileNotFoundError):
        port.load.generator(tmp_path, config, 'cpu')
    # The newest checkpoint of RUNS_DIR / CONFIG, where it fits
    checkpoint.save(tmp_path / 'run' / 'generator-00000009.pt', saved)
    assert same(port.load.generator(config=config, device='cpu'), saved)
    assert capsys.readouterr().err == ''
    # ... and where it does not, the JAX package's notice and seeded weights
    other = config.replace(NUM_SPEAKERS=3)
    generator = port.load.generator(config=other, device='cpu')
    assert 'does not match the active configuration' in \
        capsys.readouterr().err
    assert same(generator, _state(port.models.Generator(other), 0))


def test_model_loaders_read_the_checkpoint_directory(weights, tmp_path,
                                                     capsys):
    _, config, _ = weights
    for loader, name, seed in (
        (port.load.pitch_model, 'pitch', 1), (port.load.ppg_model, 'ppg', 2),
        (port.load.speaker_encoder, 'speaker', 3),
    ):
        model = loader(config=config, device='cpu')
        assert not model.training
        expected = checkpoint.load(checkpoint.latest_path(
            config.CHECKPOINTS_DIR, f'{name}-*'))['params']
        for key, value in model.state_dict().items():
            assert torch.equal(value, expected[key]), (name, key)
        path = checkpoint.latest_path(config.CHECKPOINTS_DIR, f'{name}-*')
        assert all(torch.equal(a, b) for a, b in zip(
            loader(path, config, 'cpu').state_dict().values(),
            model.state_dict().values()))
    assert port.load.pitch_model(
        config=config, device='cpu').voicing_threshold == 0.3
    assert capsys.readouterr().err == ''

    # An empty directory: the JAX package's fallbacks, each named
    empty = config.replace(CHECKPOINTS_DIR=tmp_path)
    pitch_model = port.load.pitch_model(config=empty, device='cpu')
    assert pitch_model.voicing_threshold is None
    assert all(torch.equal(a, b) for a, b in zip(
        pitch_model.state_dict().values(),
        _state(port.preprocess.PitchCNN(), 0).values()))
    port.load.ppg_model(config=empty, device='cpu')
    assert port.load.speaker_encoder(config=empty, device='cpu') is None
    err = capsys.readouterr().err
    assert err.count('using random init') == 2
    assert 'using the spectral embedding' in err


def test_converter_carries_every_trained_checkpoint(tmp_path):
    """scripts/convert_checkpoints.py: the release generator and the
    shipped pitch, PPG and speaker checkpoints, every leaf mapped"""
    spec = importlib.util.spec_from_file_location(
        'convert_checkpoints', ROOT / 'scripts' / 'convert_checkpoints.py')
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    written = converter.convert(tmp_path)
    assert _names(tmp_path) == [
        'generator-00155000.pt', 'pitch-00004000.pt', 'ppg-00003000.pt',
        'speaker-00004000.pt', 'synthetic.py'] == sorted(
            path.name for path in written)
    config = port.config.load(tmp_path / 'synthetic.py').replace(
        CHECKPOINTS_DIR=tmp_path)
    assert config.NUM_SPEAKERS == 24
    port.load.generator(tmp_path / 'generator-00155000.pt', config, 'cpu')
    pitch = port.load.pitch_model(config=config, device='cpu')
    shipped = jax_checkpoint.load(converter.SHIPPED / 'pitch')
    assert pitch.voicing_threshold == float(shipped['voicing_threshold'])
    params = jax.device_get(shipped['params'])
    dense = params['params']['Dense_0']['kernel']
    np.testing.assert_array_equal(pitch.output.weight.detach().numpy(),
                                  dense.T)
    port.load.ppg_model(config=config, device='cpu')
    assert port.load.speaker_encoder(config=config, device='cpu') is not None
    payload = checkpoint.load(tmp_path / 'speaker-00004000.pt')
    assert payload['step'] == 4000 and 'accuracy' in payload


###############################################################################
# The command-line entry points
###############################################################################


@pytest.mark.parametrize('stage', ['preprocess', 'edit', 'synthesize'])
def test_cli_help_lists_config_and_gpu(stage, monkeypatch, capsys):
    with pytest.raises(SystemExit) as exit:
        _main(stage, ['--help'], monkeypatch)
    assert exit.value.code == 0
    out = capsys.readouterr().out
    assert '--config' in out and '--gpu' in out


def test_synthesize_cli_refuses_precompile(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exit:
        _main('synthesize', ['--precompile'], monkeypatch)
    assert exit.value.code == 2
    assert 'TPU compile cache' in capsys.readouterr().err
    with pytest.raises(SystemExit) as exit:
        _main('synthesize', ['--loudness_files', 'a.npy'], monkeypatch)
    assert exit.value.code == 2
    assert '--pitch_files' in capsys.readouterr().err


def test_clis_run_on_cuda_unless_asked(weights, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; the refusal is for hosts without one')
    file, _, generator = weights
    wav = tmp_path / 'speech.wav'
    port.utils.audio.save(wav, _harmonic_audio(0.2), SAMPLE_RATE)
    with pytest.raises(RuntimeError, match='CUDA'):
        _main('preprocess', ['--files', str(wav), '--config', str(file)],
              monkeypatch)
    features = [str(tmp_path / f'x-{name}.npy') for name in range(4)]
    with pytest.raises(RuntimeError, match='CUDA'):
        _main('synthesize', [
            '--loudness_files', features[0], '--pitch_files', features[1],
            '--periodicity_files', features[2], '--ppg_files', features[3],
            '--output_files', str(tmp_path / 'out.wav'), '--checkpoint',
            str(generator), '--config', str(file)], monkeypatch)
    assert _names(tmp_path) == ['speech.wav']


def test_preprocess_cli_writes_what_from_files_to_files_writes(
    weights, tmp_path
):
    file, config, _ = weights
    wavs = []
    for name, base in (('a', 150.), ('b', 220.)):
        wavs.append(tmp_path / f'{name}.wav')
        port.utils.audio.save(
            wavs[-1], _harmonic_audio(0.3, base), SAMPLE_RATE)
    features = ['loudness', 'pitch', 'periodicity', 'ppg', 'harmonics',
                'speaker']
    (tmp_path / 'cli').mkdir()
    (tmp_path / 'ours').mkdir()
    _cli('preprocess', '--files', *wavs, '--output_prefixes',
         *(tmp_path / 'cli' / wav.stem for wav in wavs),
         '--features', *features, '--config', file)
    port.preprocess.from_files_to_files(
        wavs, port.load.pitch_model(config=config, device='cpu'),
        port.load.ppg_model(config=config, device='cpu'),
        [tmp_path / 'ours' / wav.stem for wav in wavs], features,
        config=config, device='cpu',
        speaker_model=port.load.speaker_encoder(config=config, device='cpu'))
    assert _names(tmp_path / 'ours') == sorted(
        f'{wav.stem}-{name}.npy' for wav in wavs for name in (
            'loudness', 'viterbi-pitch', 'viterbi-periodicity', 'ppg',
            'harmonics', 'speaker'))
    _assert_same_files(tmp_path / 'cli', tmp_path / 'ours')


def _feature_files(directory, frames, seed):
    rng = np.random.default_rng(seed)
    logits = 2 * rng.standard_normal((40, frames))
    values = (
        rng.uniform(-80, 10, (513, frames)),
        (160 + 40 * np.sin(np.arange(frames) / 7.))[None],
        rng.uniform(0, 1, (1, frames)),
        np.exp(logits) / np.exp(logits).sum(0))
    files = []
    for name, value in zip(('loudness', 'viterbi-pitch',
                            'viterbi-periodicity', 'ppg'), values):
        files.append(directory / f'{seed}-{name}.npy')
        np.save(files[-1], value.astype(np.float32))
    return files


def test_edit_cli_writes_what_from_files_to_files_writes(weights, tmp_path):
    file, config, _ = weights
    inputs = [_feature_files(tmp_path, 50, seed) for seed in (1, 2)]
    edit = dict(pitch_shift_cents=400., time_stretch_ratio=1.4,
                loudness_scale_db=3.)
    (tmp_path / 'cli').mkdir()
    (tmp_path / 'ours').mkdir()
    _cli('edit', *[argument for name, files in zip(
            ('loudness', 'pitch', 'periodicity', 'ppg'), zip(*inputs))
          for argument in (f'--{name}_files', *files)],
         '--output_prefixes', tmp_path / 'cli' / 'a', tmp_path / 'cli' / 'b',
         *[argument for name, value in edit.items()
           for argument in (f'--{name}', value)],
         '--no-stretch_unvoiced', '--save_grid', '--config', file)
    port.edit.from_files_to_files(
        *zip(*inputs), [tmp_path / 'ours' / 'a', tmp_path / 'ours' / 'b'],
        stretch_unvoiced=False, save_grid=True, config=config, device='cpu',
        **edit)
    assert len(_names(tmp_path / 'ours')) == 10
    _assert_same_files(tmp_path / 'cli', tmp_path / 'ours')


def test_synthesize_cli_writes_what_from_files_to_files_writes(
    weights, tmp_path
):
    file, config, generator = weights
    inputs = [_feature_files(tmp_path, 40, seed) for seed in (3, 4)]
    (tmp_path / 'cli').mkdir()
    (tmp_path / 'ours').mkdir()
    _cli('synthesize', *[argument for name, files in zip(
            ('loudness', 'pitch', 'periodicity', 'ppg'), zip(*inputs))
          for argument in (f'--{name}_files', *files)],
         '--output_files', tmp_path / 'cli' / 'a.wav',
         tmp_path / 'cli' / 'b.wav', '--speakers', 3, 5,
         '--loudness_ratio', 1.1, '--checkpoint', generator, '--config', file)
    port.synthesize.from_files_to_files(
        *zip(*inputs), [tmp_path / 'ours' / 'a.wav',
                        tmp_path / 'ours' / 'b.wav'],
        port.load.generator(generator, config, 'cpu'), speakers=[3, 5],
        loudness_ratio=1.1, device='cpu')
    assert _names(tmp_path / 'ours') == ['a.wav', 'b.wav']
    _assert_same_files(tmp_path / 'cli', tmp_path / 'ours')
