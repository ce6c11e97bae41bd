"""The exported packed-inference program and the command lines of this
slice, on the CPU.

A CPU `torch.export` round trip of `models.export.PackedInference`
(export, save, load in this process) gives the eager audio within 1e-6;
`python -m promonet_tpu_torch.models.export` writes a program that gives
the generator's audio within 1e-6 and the generator's parameters; `python
-m promonet_tpu_torch.data.pack`, `...partition` and
`...data.preprocess` write what their functions write. The generator is
float32, 32 channels wide, with one Block per stage (kernel size 3):
tracing and serialising the plain chain of all twelve Blocks takes four
times as long, and the program's twelve Blocks at full width are the
card's to check (`chip_smoke.py`).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import promonet_tpu_torch as port
from promonet_tpu_torch.models import export

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 32
SMALL = dict(
    HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH, PRECISION='float32',
    HIFIGAN_RESBLOCK_KERNEL_SIZES=[3],
    HIFIGAN_RESBLOCK_DILATION_SIZES=[[1, 3, 5]])


def _config(**overrides):
    return port.config.load().replace(**dict(SMALL, **overrides))


def _generator():
    """A float32 generator of one Block per stage, seeded"""
    return port.models.init.seeded(
        port.models.Generator(_config()), 0).eval()


def _packed(seed=2, frames=8):
    rng = np.random.default_rng(seed)
    ppg = rng.random((1, 40, frames)).astype(np.float32)
    return export.pack_features(
        torch.from_numpy(rng.uniform(-80, 0, (1, 513, frames)).astype(
            np.float32)),
        torch.from_numpy(rng.uniform(80, 300, (1, frames)).astype(
            np.float32)),
        torch.from_numpy(rng.random((1, frames)).astype(np.float32)),
        torch.from_numpy(ppg / ppg.sum(1, keepdims=True)),
        torch.tensor([3]), torch.tensor([1.2]), torch.tensor([.9]),
        _config())


def _run(*arguments, timeout=240):
    result = subprocess.run(
        [sys.executable, '-m', *map(str, arguments)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert result.returncode == 0, result.stderr
    return result


def _config_file(directory, **values):
    path = directory / 'config.py'
    path.write_text("MODULE = 'promonet_tpu'\n" + ''.join(
        f'{name} = {value!r}\n' for name, value in values.items()))
    return path


def test_exported_program_round_trips_on_the_cpu(tmp_path):
    generator = _generator()
    program = export.PackedInference(generator).eval()
    x = _packed()
    exported = torch.export.export(program, (x,))
    torch.export.save(exported, tmp_path / 'program.pt2')
    loaded = torch.export.load(tmp_path / 'program.pt2')
    with torch.no_grad():
        eager = program(x)
        again = loaded.module()(x)
    assert again.shape == eager.shape == (1, 1, 8 * 256)
    np.testing.assert_allclose(again.numpy(), eager.numpy(), atol=1e-6)




def test_export_command_line_writes_the_program(tmp_path):
    generator = _generator()
    checkpoint = tmp_path / 'generator-00000001.pt'
    port.utils.checkpoint.save(checkpoint, generator.state_dict(), step=1)
    _run('promonet_tpu_torch.models.export', '--checkpoint', checkpoint,
         '--output_file', tmp_path / 'exported', '--config',
         _config_file(tmp_path, **SMALL), '--gpu', '-1')
    saved = port.utils.checkpoint.load(tmp_path / 'exported.pt')['params']
    assert set(saved) == set(generator.state_dict())
    for name, value in generator.state_dict().items():
        assert torch.equal(saved[name], value), name
    program = torch.export.load(tmp_path / 'exported.pt2').module()
    # The JAX package's self-check shape: a buffer of 8192 samples
    x = _packed(frames=8192 // 256)
    with torch.no_grad():
        audio = program(x)
        expected = export.packed_inference(generator, x)
    assert audio.shape == (1, 1, 8192)
    np.testing.assert_allclose(audio.numpy(), expected.numpy(), atol=1e-6)


def test_dataset_command_lines_write_what_their_functions_write(tmp_path):
    """`python -m ...data.preprocess`, `...partition` and `...data.pack`
    against the same calls in this process, on one small corpus (the
    extractors seeded where no checkpoint is, on both sides)"""
    values = dict(
        CACHE_DIR=str(tmp_path / 'cli' / 'cache'),
        PARTITIONS_DIR=str(tmp_path / 'cli' / 'partitions'),
        CHECKPOINTS_DIR=str(tmp_path / 'checkpoints'),
        RUNS_DIR=str(tmp_path / 'runs'))
    config = port.config.load().replace(**{
        name: Path(value) for name, value in values.items()})
    here = config.replace(
        CACHE_DIR=tmp_path / 'here' / 'cache',
        PARTITIONS_DIR=tmp_path / 'here' / 'partitions')
    for where in (config, here):
        port.data.synthetic.create(
            speakers=2, utterances=2, seconds=0.3, preprocess=False,
            config=where, device='cpu')
    config_file = _config_file(tmp_path, **values)
    features = ['loudness', 'pitch', 'periodicity', 'ppg']
    _run('promonet_tpu_torch.data.preprocess', '--datasets', 'synthetic',
         '--features', *features, '--gpu', '-1', '--config', config_file)
    port.data.preprocess.datasets(
        ['synthetic'], tuple(features), config=here, device='cpu')
    written = sorted(
        path.relative_to(config.CACHE_DIR)
        for path in config.CACHE_DIR.rglob('*.npy'))
    assert written == sorted(
        path.relative_to(here.CACHE_DIR)
        for path in here.CACHE_DIR.rglob('*.npy'))
    assert any(path.name.endswith('-ppg.npy') for path in written)
    for path in written:
        np.testing.assert_array_equal(
            np.load(config.CACHE_DIR / path), np.load(here.CACHE_DIR / path),
            err_msg=str(path))

    _run('promonet_tpu_torch.partition', '--datasets', 'synthetic',
         '--config', config_file)
    port.partition.datasets(['synthetic'], here)
    assert port.load.partition('synthetic', False, config) == \
        port.load.partition('synthetic', False, here)

    stem = sorted((config.CACHE_DIR / 'synthetic').glob('*/*.wav'))[0]
    prefix = stem.parent / stem.stem
    _run('promonet_tpu_torch.data.pack', '--prefixes', prefix, prefix,
         '--output_files', tmp_path / 'packed.npy', tmp_path / 'packed.csv',
         '--speaker', '1', '--config', config_file)
    packed = port.data.pack.from_features(
        *port.load.features(prefix, config), speaker=1, config=config)
    np.testing.assert_array_equal(
        np.load(tmp_path / 'packed.npy'), packed[0].numpy())
    rows = np.loadtxt(tmp_path / 'packed.csv', delimiter=',', skiprows=1)
    np.testing.assert_allclose(rows[:, 1:].T, packed[0].numpy(), rtol=1e-6)
