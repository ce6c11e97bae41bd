"""PyTorch port's DSP ops held against the JAX package's.

Inputs are made with numpy from a seed and go through both packages;
tolerances are float32 rounding of FFT, log and sum orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.ops import grid as jax_grid
from promonet_tpu.ops import mel as jax_mel
from promonet_tpu.ops import sparse as jax_sparse
from promonet_tpu.ops import spectral as jax_spectral
from promonet_tpu.ops import stft as jax_stft
from promonet_tpu.preprocess import loudness as jax_loudness
from promonet_tpu.preprocess import spectrogram as jax_spectrogram

import promonet_tpu_torch as port
from promonet_tpu_torch.ops import grid, mel, sparse, spectral, stft


def _audio(seed, samples=8192):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 22050
    signal = np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(samples)
    return (0.4 * signal / np.abs(signal).max()).astype(np.float32)[None]


def test_hann_window_matches_jax_and_torch():
    ours = stft.hann_window(1024).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jax_stft.hann_window(1024)))
    np.testing.assert_allclose(
        ours, torch.hann_window(1024).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize('epsilon', [0., 1e-6])
def test_stft_magnitude_matches_jax(epsilon):
    audio = _audio(0)
    window = stft.hann_window(1024)
    ours = stft.stft(
        stft.reflect_pad(torch.from_numpy(audio[0]), 384), 1024, 256,
        window=window, magnitude=True, magnitude_epsilon=epsilon).numpy()
    theirs = np.asarray(jax_stft.stft(
        jax_stft.reflect_pad(jnp.asarray(audio[0]), 384), 1024, 256,
        window=jax_stft.hann_window(1024), magnitude=True,
        magnitude_epsilon=epsilon))
    assert ours.shape == theirs.shape == (513, 32)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def test_amplitude_to_db_and_a_weighting_match_jax():
    rng = np.random.default_rng(1)
    amplitude = np.abs(rng.standard_normal((513, 20))).astype(np.float32)
    amplitude[:, :3] = 0.
    np.testing.assert_allclose(
        spectral.amplitude_to_db(torch.from_numpy(amplitude)).numpy(),
        np.asarray(jax_spectral.amplitude_to_db(jnp.asarray(amplitude))),
        rtol=0, atol=1e-4)
    frequencies = spectral.fft_frequencies(22050, 1024)
    np.testing.assert_array_equal(
        spectral.a_weighting(frequencies),
        jax_spectral.a_weighting(frequencies))


def test_mel_filterbank_and_log_mel_match_jax():
    np.testing.assert_array_equal(
        mel.mel_filterbank(22050, 1024, 80),
        np.asarray(jax_mel.mel_filterbank(22050, 1024, 80)))
    rng = np.random.default_rng(2)
    spec = (np.abs(rng.standard_normal((513, 17))) + 1e-3).astype(np.float32)
    np.testing.assert_allclose(
        mel.linear_to_mel(torch.from_numpy(spec), 22050, 1024, 80).numpy(),
        np.asarray(jax_mel.linear_to_mel(jnp.asarray(spec), 22050, 1024, 80)),
        rtol=1e-5, atol=1e-5)


def test_loudness_and_spectrogram_extractors_match_jax():
    config = port.config.load()
    audio = _audio(3, 16384)
    ours = port.preprocess.loudness.from_audio(
        torch.from_numpy(audio), config, bands=None).numpy()
    theirs = np.asarray(jax_loudness._from_audio_jit(jnp.asarray(audio), None))
    assert ours.shape == theirs.shape == (513, 64)
    # dB of float32 FFT magnitudes: ~1e-5 relative → ~1e-4 dB
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-3)
    ours = port.preprocess.loudness.band_average(torch.from_numpy(theirs), 8)
    np.testing.assert_allclose(
        ours.numpy(),
        np.asarray(jax_loudness.band_average(jnp.asarray(theirs), 8)),
        rtol=1e-6, atol=1e-4)

    ours = port.preprocess.spectrogram.from_audio(
        torch.from_numpy(audio)[None], config)[0]
    theirs = np.asarray(jax_spectrogram._from_audio_jit(
        jnp.asarray(audio)[None], False, None))[0]
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('method,threshold', [
    ('percentile', 0.85), ('constant', 0.05), ('topk', 3)])
def test_sparsify_matches_jax(method, threshold):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 40, 30)) * 3
    ppg = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    ppg = ppg.astype(np.float32)
    # Ties at the cutoff: the mask decides on one rounding step
    ppg[:, 30:, 0] = ppg[:, 30:31, 0]
    ours = sparse.sparsify(torch.from_numpy(ppg), method, threshold).numpy()
    theirs = np.asarray(
        jax_sparse.sparsify(jnp.asarray(ppg), method, threshold))
    np.testing.assert_array_equal(ours == 0, theirs == 0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_quantile_matches_jnp_quantile():
    rng = np.random.default_rng(5)
    x = rng.random((3, 40, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        sparse.quantile(torch.from_numpy(x), 0.85, dim=-2).numpy(),
        np.asarray(jnp.quantile(jnp.asarray(x), 0.85, axis=-2, keepdims=True)))


@pytest.mark.parametrize('ratio', [1 / 1.4, 1.414, 1.])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_grid_constant_and_sample_match_jax(ratio, method):
    rng = np.random.default_rng(6)
    sequence = rng.standard_normal((5, 37)).astype(np.float32)
    ours_grid = grid.constant(torch.from_numpy(sequence), ratio)
    theirs_grid = jax_grid.constant(jnp.asarray(sequence), ratio)
    assert ours_grid.shape == theirs_grid.shape
    np.testing.assert_allclose(
        ours_grid.numpy(), np.asarray(theirs_grid), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        grid.sample(torch.from_numpy(sequence), ours_grid, method).numpy(),
        np.asarray(jax_grid.sample(
            jnp.asarray(sequence), theirs_grid, method)),
        rtol=1e-5, atol=1e-5)


def test_grid_of_length_matches_jax():
    sequence = torch.zeros(3, 10)
    np.testing.assert_allclose(
        grid.of_length(sequence, 23).numpy(),
        np.asarray(jax_grid.of_length(jnp.zeros((3, 10)), 23)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize('values,mask', [
    # Interior gaps interpolate linearly
    ([1., 99., 99., 4., 99., 6.], [True, False, False, True, False, True]),
    # Edges take the nearest anchor
    ([99., 2., 4., 99., 99., 99.], [False, True, True, False, False, False]),
    # One anchor, no anchor, every position an anchor
    ([5., 7., 9.], [False, True, False]),
    ([5., 7., 9.], [False, False, False]),
    ([5., 7., 9.], [True, True, True]),
    ([3.], [False]),
])
def test_masked_interp_matches_jax(values, mask):
    ours = grid.masked_interp(torch.tensor(values), torch.tensor(mask))
    theirs = np.asarray(jax_grid.masked_interp(
        jnp.asarray(values), jnp.asarray(mask)))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)
    assert ours.dtype == torch.float32


def test_masked_interp_matches_jax_on_a_random_contour():
    rng = np.random.default_rng(8)
    values = rng.standard_normal(300).astype(np.float32)
    mask = rng.random(300) > 0.6
    ours = grid.masked_interp(torch.from_numpy(values), torch.from_numpy(mask))
    theirs = np.asarray(jax_grid.masked_interp(
        jnp.asarray(values), jnp.asarray(mask)))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours.numpy()[mask], values[mask])
    np.testing.assert_allclose(
        ours.numpy(),
        np.interp(np.arange(300), np.flatnonzero(mask), values[mask]),
        rtol=1e-5, atol=1e-5)


def test_config_matches_jax_package():
    config = port.config.load()
    for name in (
        'HOPSIZE', 'SAMPLE_RATE', 'NUM_FEATURES', 'GLOBAL_CHANNELS',
        'NUM_SPEAKERS', 'INFERENCE_FRAME_BUCKETS', 'LOG_FMIN', 'PRECISION',
        'HIFIGAN_RESBLOCK_KERNEL_SIZES', 'PITCH_ESTIMATOR',
        'MAX_HARMONICS', 'VOICING_THRESHOLD', 'VITERBI_DECODE_PITCH',
    ):
        assert getattr(config, name) == getattr(promonet_tpu, name), name
    from promonet_tpu.data.collate import bucket_frames
    for frames in (1, 64, 65, 861, 1205, 4096, 5000):
        assert port.data.bucket_frames(
            frames, config.INFERENCE_FRAME_BUCKETS) == bucket_frames(frames)


def test_config_reads_the_same_override_files(monkeypatch, tmp_path):
    synthetic = port.config.load('runs/promonet/synthetic.py')
    assert synthetic.TRAINING_DATASET == 'synthetic'
    assert synthetic.NUM_SPEAKERS == 24
    assert synthetic.PITCH_ESTIMATOR == 'dsp'
    override = tmp_path / 'narrow.py'
    override.write_text(
        "MODULE = 'promonet_tpu'\nHIFIGAN_UPSAMPLE_INITIAL_SIZE = 64\n")
    ignored = tmp_path / 'other.py'
    ignored.write_text("MODULE = 'other'\nHOPSIZE = 1\n")
    monkeypatch.setenv(
        'PROMONET_TPU_TORCH_CONFIG', f'{override}:{ignored}')
    config = port.config.load()
    assert config.HIFIGAN_UPSAMPLE_INITIAL_SIZE == 64
    assert config.HOPSIZE == 256
    assert synthetic.replace(TRAINING_DATASET='vctk').NUM_SPEAKERS == 109


def test_pitch_distribution_reads_shipped_statistics():
    synthetic = port.config.load('runs/promonet/synthetic.py')
    np.testing.assert_array_equal(
        port.load.pitch_distribution(synthetic),
        np.load(
            'promonet_tpu/assets/stats/'
            'synthetic-256-loudness-pitch-viterbi.npy'))
    fallback = port.load.pitch_distribution(port.config.load())
    np.testing.assert_array_equal(
        fallback, np.asarray(promonet_tpu.load.pitch_distribution()))
