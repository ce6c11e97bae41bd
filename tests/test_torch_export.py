"""Packed features, packed inference and the residual-block operator in
an exported program, held against the JAX package.

`pack_features` agrees with the JAX package's on the same numpy-seeded
features exactly in pitch, periodicity, speaker and ratios, and within
1e-6 relative (a few float32 steps) in the band-averaged loudness and the
sparsified PPG, float32 sums that XLA adds in another order;
`unpack_features` is exact; `data.pack` writes the same .npy and .csv
files to those tolerances, the CSV header `time` and `labels()`.
`packed_inference` of a narrow float32 generator (HiFi-GAN 32 channels)
runs the generator on the unpacked tensor exactly, and agrees with the
JAX package's on the same packed tensor and bridged weights within 1e-5.
A CPU `torch.export` round trip of the residual-block operator is exact;
the generator's round trips and the command lines are in
`test_torch_export_program.py`.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.data.pack as jax_pack
from promonet_tpu.models import export as jax_export

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge, export
from promonet_tpu_torch.ops import resblock

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 32
FRAMES = 8


def _features(seed, batch=2, frames=FRAMES):
    rng = np.random.default_rng(seed)
    ppg = rng.random((batch, 40, frames)).astype(np.float32)
    return (
        rng.uniform(-80, 0, (batch, 513, frames)).astype(np.float32),
        rng.uniform(80, 300, (batch, frames)).astype(np.float32),
        rng.random((batch, frames)).astype(np.float32),
        ppg / ppg.sum(1, keepdims=True),
        np.array([3, 7], np.int32)[:batch],
        np.array([1., 1.2], np.float32)[:batch],
        np.array([.9, 1.], np.float32)[:batch])


def _config(**overrides):
    return port.config.load().replace(**dict(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=WIDTH, PRECISION='float32',
        **overrides))


def _torch(features):
    return [torch.from_numpy(np.asarray(value)) for value in features]


###############################################################################
# Packed features
###############################################################################


def test_labels_match_jax():
    assert export.labels(_config()) == jax_export.labels()
    assert len(export.labels(_config())) == 8 + 2 + 40 + 3


def _assert_packed_equal(ours, theirs):
    """Pitch, periodicity, speaker and ratios equal; the band-averaged
    loudness and the sparsified PPG (float32 sums in another order) within
    1e-6 relative"""
    exact = [8, 9, 50, 51, 52]
    np.testing.assert_array_equal(
        ours[..., exact, :], theirs[..., exact, :])
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_pack_and_unpack_match_jax():
    features = _features(0)
    theirs = np.asarray(jax_export.pack_features(*features))
    ours = export.pack_features(*_torch(features), config=_config())
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape
    _assert_packed_equal(ours.numpy(), theirs)
    unpacked_theirs = jax_export.unpack_features(theirs)
    unpacked_ours = export.unpack_features(torch.from_numpy(theirs), _config())
    for mine, value in zip(unpacked_ours, unpacked_theirs):
        assert tuple(mine.shape) == tuple(np.shape(value))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(value))
    assert unpacked_ours[4].dtype == torch.int64
    assert unpacked_ours[4].tolist() == [3, 7]


def test_pack_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    prefix = tmp_path / 'utterance'
    np.save(f'{prefix}-loudness.npy',
            rng.uniform(-80, 0, (513, 12)).astype(np.float32))
    for name in ('pitch', 'periodicity'):
        np.save(f'{prefix}-viterbi-{name}.npy',
                rng.uniform(.1, 300, (1, 12)).astype(np.float32))
    ppg = rng.random((40, 12)).astype(np.float32)
    np.save(f'{prefix}-ppg.npy', ppg / ppg.sum(0))
    config = _config()
    for suffix in ('npy', 'csv'):
        jax_pack.from_file_to_file(
            prefix, tmp_path / f'theirs.{suffix}', speaker=2)
        port.data.pack.from_file_to_file(
            prefix, tmp_path / f'ours.{suffix}', config, speaker=2)
    _assert_packed_equal(
        np.load(tmp_path / 'ours.npy'), np.load(tmp_path / 'theirs.npy'))
    header = (tmp_path / 'ours.csv').read_text().splitlines()[0]
    assert header == (tmp_path / 'theirs.csv').read_text().splitlines()[0]
    assert header.split(',') == ['time'] + export.labels(config)
    rows, their_rows = (
        np.loadtxt(tmp_path / f'{side}.csv', delimiter=',', skiprows=1)
        for side in ('ours', 'theirs'))
    np.testing.assert_array_equal(rows[:, 0], their_rows[:, 0])
    _assert_packed_equal(rows[:, 1:].T, their_rows[:, 1:].T)
    packed = port.data.pack.from_features(
        *port.load.features(prefix, config), speaker=2, config=config)
    np.testing.assert_array_equal(
        packed[0].numpy(), np.load(tmp_path / 'ours.npy'))
    np.testing.assert_allclose(
        rows[:, 0], np.arange(12) * 256 / config.SAMPLE_RATE)


###############################################################################
# Packed inference and the exported program
###############################################################################


@pytest.fixture(scope='module')
def generators():
    """A narrow float32 JAX generator and the port's with its weights"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE', WIDTH)
        patch.setattr(promonet_tpu, 'PRECISION', 'float32')
        model = promonet_tpu.models.Generator.create()
        features = _features(2, batch=1)
        params = jax.device_get(model.init(jax.random.PRNGKey(0), *features))
        packed = np.asarray(jax_export.pack_features(*features))
        theirs = np.asarray(jax.jit(
            lambda x: jax_export.packed_inference(model, params, x))(packed))
    generator = port.models.Generator(_config())
    generator.load_state_dict(bridge.generator_state_dict(params))
    return generator.eval(), features, packed, theirs


def test_packed_inference_matches_the_generator_and_jax(generators):
    generator, features, packed, theirs = generators
    x = torch.from_numpy(packed)
    with torch.no_grad():
        ours = export.packed_inference(generator, x)
        direct = generator(*export.unpack_features(x, generator.config))
        unpacked = generator(*_torch(features))
    assert ours.shape == (1, 1, FRAMES * 256)
    assert torch.equal(ours, direct)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    # The packed loudness is band-averaged once and the PPG sparsified
    # twice: the same audio as from the features themselves, to rounding
    np.testing.assert_allclose(ours.numpy(), unpacked.numpy(), atol=1e-5)


def test_block_operator_round_trips_in_an_exported_program(tmp_path):
    """The registered residual-block operator, its CPU version over packed
    bf16 tiles: in the graph, and exact after save and load"""
    rng = np.random.default_rng(3)
    weights = torch.from_numpy(
        0.05 * rng.standard_normal((6, 3, 48, 48))).float()
    biases = torch.from_numpy(0.1 * rng.standard_normal((6, 48))).float()
    packed = resblock.pack_weights(weights, biases)

    class Blocks(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer('tiles', packed.tensor)
            self.register_buffer('biases', packed.biases)

        def forward(self, x):
            return resblock.fused_block(
                x, resblock.Packed(self.tiles, self.biases, 48, 3), None,
                (1, 3, 5), 0.1)

    x = torch.from_numpy(rng.standard_normal((1, 40, 48))).to(torch.bfloat16)
    module = Blocks()
    exported = torch.export.export(module, (x,))
    targets = [str(node.target) for node in exported.graph.nodes]
    assert 'promonet_tpu_torch.resblock.default' in targets
    torch.export.save(exported, tmp_path / 'blocks.pt2')
    loaded = torch.export.load(tmp_path / 'blocks.pt2').module()
    weights_bf16, biases_bf16 = resblock.unpack_weights(packed)
    expected = resblock.reference_block(
        x, weights_bf16, biases_bf16, (1, 3, 5), 0.1, torch.bfloat16)
    assert torch.equal(loaded(x), expected)
    assert torch.equal(module(x), expected)


def test_frozen_block_serves_its_packed_buffers():
    block = port.models.hifigan.Block(64, 3, (1, 3, 5), 0.1)
    port.models.init.seeded(block, 0)
    block.freeze()
    packed = block.packed()
    reference = resblock.pack_weights(block.weight, block.bias)
    assert torch.equal(packed.tensor, reference.tensor)
    assert torch.equal(packed.biases, reference.biases)
    assert (packed.channels, packed.kernel_size) == (64, 3)
    # Buffers, not state: a checkpoint of the module does not carry them
    assert 'packed_tiles' not in block.state_dict()
