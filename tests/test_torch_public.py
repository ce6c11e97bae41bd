"""Public functions of the JAX package that the port gained late, and the
two repairs of short inputs and of `loudness.shift`, held against the JAX
package on the same numpy-seeded inputs.

Tolerances: unit and time conversions, grids from alignments (float64
numpy on both sides), the receptive field, Viterbi paths and per-speaker
averages (float64 means of the same files): equal. Spectrograms within
1e-5 of their largest value; loudness within 2e-3 dB, as
`test_torch_ops.py` holds it (quiet bins round otherwise in dB); log-mels
within 1e-5 absolute and relative; PPGs within 1e-5; speaker embeddings,
unit vectors, within 1e-6 per element, as `test_torch_speaker.py` holds
them; `loudness.shift` within 4e-8. The public names the port gained
last (`model`, `models.get_padding`, `models.discriminator.
gen_filterbank`) equal; `utils.timer.profile` writes a trace. The JAX
package's defaults and parameters: the band-mean loudness, MAX_HARMONICS
in `harmonics.viterbi` (paths equal), `mel_filterbank`'s band (equal)
and the centred STFT (within 1e-5 of its largest value).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
import promonet_tpu.convert as jax_convert
from promonet_tpu.edit import grid as jax_edit_grid
from promonet_tpu.ops import mel as jax_mel
from promonet_tpu.models import hifigan as jax_hifigan
from promonet_tpu.ops import grid as jax_grid
from promonet_tpu.ops import stft as jax_stft
from promonet_tpu.ops import viterbi as jax_viterbi
from promonet_tpu.preprocess import harmonics as jax_harmonics
from promonet_tpu.preprocess import loudness as jax_loudness
from promonet_tpu.preprocess import ppg as jax_ppg
from promonet_tpu.preprocess import spectrogram as jax_spectrogram
from promonet_tpu.preprocess import speaker as jax_speaker
from promonet_tpu.utils import checkpoint as jax_checkpoint

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from promonet_tpu_torch.ops import stft

# Sample counts around the reflect padding of (NUM_FFT - HOPSIZE) / 2 =
# 384: below 256 no frame fits, and up to 384 the padding is not shorter
# than the input
SHORT = (1, 2, 256, 300, 383, 384, 385, 2048)
CONFIG = port.config.load()


def _speech(samples, seed=0):
    """Harmonic audio with a noise floor, (1, samples) float32"""
    t = np.arange(samples) / 22050
    phase = 2 * np.pi * np.cumsum(150. + 40. * np.sin(2 * np.pi * 3. * t)) \
        / 22050
    audio = sum(0.5 ** k * np.sin(k * phase) for k in range(1, 5))
    audio += 0.01 * np.random.default_rng(seed).standard_normal(samples)
    return (0.4 * audio).astype(np.float32)[None]


@pytest.fixture(scope='module')
def models():
    """The shipped speaker and PPG checkpoints: the port's models"""
    speaker = port.preprocess.SpeakerEncoder()
    speaker.load_state_dict(bridge.speaker_state_dict(jax.device_get(
        jax_checkpoint.load(promonet_tpu.ASSETS_DIR / 'checkpoints' /
                            'speaker')['params'])))
    ppg = port.preprocess.PPGEncoder()
    ppg.load_state_dict(bridge.ppg_state_dict(jax.device_get(
        jax_checkpoint.load(promonet_tpu.ASSETS_DIR / 'checkpoints' /
                            'ppg')['params'])))
    return speaker.eval(), ppg.eval()


###############################################################################
# Short inputs: reflect padding
###############################################################################


@pytest.mark.parametrize('length', [1, 2, 3, 5, 256, 300, 384, 385, 2048])
def test_reflect_pad_reflects_again_and_again_as_numpy(length):
    audio = np.random.default_rng(length).standard_normal(
        (2, 1, length)).astype(np.float32)
    for padding in (0, 1, length - 1, length, 2 * length + 1, 384, 1000):
        theirs = np.pad(
            audio, ((0, 0), (0, 0), (padding, padding)), mode='reflect')
        assert np.array_equal(
            stft.reflect_pad(torch.from_numpy(audio), padding).numpy(),
            theirs)
    # The JAX package's own, at the spectrogram's padding
    assert np.array_equal(
        stft.reflect_pad(torch.from_numpy(audio), 384).numpy(),
        np.asarray(jax_stft.reflect_pad(jnp.asarray(audio), 384)))


@pytest.mark.parametrize('samples', SHORT)
def test_spectrogram_of_short_audio_matches_jax(samples):
    audio = _speech(samples)
    for mels in (False, True):
        theirs = np.asarray(jax_spectrogram.from_audio(audio, mels=mels))
        ours = port.preprocess.spectrogram.from_audio(
            torch.from_numpy(audio), CONFIG, mels=mels).numpy()
        assert ours.shape == theirs.shape
        if theirs.size:
            np.testing.assert_allclose(
                ours, theirs, rtol=1e-5 if mels else 0,
                atol=1e-5 * (1 if mels else np.abs(theirs).max()))


@pytest.mark.parametrize('samples', SHORT)
def test_loudness_of_short_audio_matches_jax(samples):
    audio = _speech(samples)
    if samples < 256:
        # No frame: both packages raise on the maximum of nothing
        with pytest.raises(ValueError):
            jax_loudness.from_audio(audio, bands=None)
        with pytest.raises(RuntimeError):
            port.preprocess.loudness.from_audio(
                torch.from_numpy(audio), CONFIG, bands=None)
        return
    theirs = np.asarray(jax_loudness.from_audio(audio, bands=None))
    ours = port.preprocess.loudness.from_audio(
        torch.from_numpy(audio), CONFIG, bands=None).numpy()
    assert ours.shape == theirs.shape == (513, 1 + (samples - 256) // 256)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-3)


@pytest.mark.parametrize('samples', SHORT)
def test_speaker_embeddings_of_short_audio_match_jax(
        samples, models, monkeypatch):
    monkeypatch.setattr(jax_speaker, '_wavlm', lambda: None)
    encoder, _ = models
    audio = _speech(samples)
    theirs = np.asarray(jax_speaker.encoder_embedding(audio))
    ours = port.preprocess.speaker.encoder_embedding(
        audio, encoder, CONFIG, 'cpu').numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)

    theirs = promonet_tpu.preprocess.from_audio(audio, features=('speaker',))
    ours = port.preprocess.from_audio(
        audio, None, None, features=('speaker',), device='cpu',
        speaker_model=encoder)
    np.testing.assert_allclose(
        ours[0].numpy(), np.asarray(theirs[0]), rtol=0, atol=1e-6)

    if samples < 256:
        with pytest.raises(IndexError):
            jax_speaker.spectral_embedding(audio)
        with pytest.raises(RuntimeError):
            port.preprocess.speaker.spectral_embedding(audio, CONFIG, 'cpu')
        return
    np.testing.assert_allclose(
        port.preprocess.speaker.spectral_embedding(
            audio, CONFIG, 'cpu').numpy(),
        jax_speaker.spectral_embedding(audio), rtol=0, atol=1e-6)


###############################################################################
# Loudness
###############################################################################


def test_shift_by_a_float64_value_per_frame_stays_float32():
    audio = _speech(2048)
    value = np.random.default_rng(1).uniform(-6., 6., 8)
    theirs = np.asarray(jax_loudness.shift(jnp.asarray(audio), value))
    ours = port.preprocess.loudness.shift(torch.from_numpy(audio), value)
    assert ours.dtype == torch.float32 and theirs.dtype == np.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=4e-8)
    # A scalar, and a float64 tensor, too
    assert port.preprocess.loudness.shift(
        torch.from_numpy(audio), 3.).dtype == torch.float32
    assert port.preprocess.loudness.shift(
        torch.from_numpy(audio), torch.from_numpy(value)).dtype == \
        torch.float32


def test_loudness_normalize_and_files_match_jax(tmp_path):
    loudness = np.random.default_rng(2).uniform(
        -120., 40., (513, 9)).astype(np.float32)
    np.testing.assert_allclose(
        port.preprocess.loudness.normalize(torch.from_numpy(loudness)),
        jax_loudness.normalize(loudness), rtol=1e-6, atol=1e-7)

    files = []
    for index, samples in enumerate((4096, 6000)):
        file = tmp_path / f'{index}.wav'
        port.utils.audio.save(file, _speech(samples, index), 22050)
        files.append(file)
    for bands in (None, 1):
        theirs = np.asarray(jax_loudness.from_file(files[0], bands))
        ours = port.preprocess.loudness.from_file(
            files[0], bands, CONFIG, 'cpu').numpy()
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-3)
    ours_files = [tmp_path / f'ours-{i}.npy' for i in range(2)]
    theirs_files = [tmp_path / f'theirs-{i}.npy' for i in range(2)]
    port.preprocess.loudness.from_files_to_files(
        files, ours_files, config=CONFIG, device='cpu')
    jax_loudness.from_files_to_files(files, theirs_files)
    for ours, theirs in zip(ours_files, theirs_files):
        assert np.load(ours).shape == np.load(theirs).shape == (
            8, np.load(theirs).shape[-1])
        np.testing.assert_allclose(
            np.load(ours), np.load(theirs), rtol=0, atol=2e-3)


def test_spectrogram_files_match_jax(tmp_path):
    file = tmp_path / 'speech.wav'
    port.utils.audio.save(file, _speech(5000), 22050)
    for mels in (False, True):
        ours, theirs = tmp_path / f'ours-{mels}.npy', \
            tmp_path / f'theirs-{mels}.npy'
        port.preprocess.spectrogram.from_files_to_files(
            [file], [ours], mels, CONFIG, 'cpu')
        jax_spectrogram.from_files_to_files([file], [theirs], mels)
        theirs = np.load(theirs)
        np.testing.assert_allclose(
            np.load(ours), theirs, rtol=1e-5 if mels else 0,
            atol=1e-5 * (1 if mels else np.abs(theirs).max()))
        assert port.preprocess.spectrogram.from_file(
            file, mels, CONFIG, 'cpu').shape == theirs.shape


###############################################################################
# PPG
###############################################################################


def test_ppg_from_audio_and_files_match_jax(models, tmp_path):
    _, model = models
    audio = _speech(9000, 3)
    theirs = np.asarray(jax_ppg.from_audio(audio))
    ours = port.preprocess.ppg.from_audio(audio, model, CONFIG, 'cpu')
    assert tuple(ours.shape) == theirs.shape == (40, 35)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)

    file = tmp_path / 'speech.wav'
    port.utils.audio.save(file, audio, 22050)
    port.preprocess.ppg.from_files_to_files(
        [file], [tmp_path / 'ours.npy'], model, CONFIG, 'cpu')
    jax_ppg.from_files_to_files([file], [tmp_path / 'theirs.npy'])
    np.testing.assert_allclose(
        np.load(tmp_path / 'ours.npy'), np.load(tmp_path / 'theirs.npy'),
        rtol=0, atol=1e-5)

    # Without a model, `load.ppg_model` of config: its checkpoint
    checkpoints = tmp_path / 'checkpoints'
    port.utils.checkpoint.save(
        checkpoints / 'ppg-00000001.pt', model.state_dict(), step=1)
    np.testing.assert_array_equal(
        port.preprocess.ppg.from_file(
            file, config=CONFIG.replace(CHECKPOINTS_DIR=checkpoints),
            device='cpu').numpy(),
        np.load(tmp_path / 'ours.npy'))


###############################################################################
# Conversions, grids, the receptive field, Viterbi
###############################################################################


@pytest.mark.parametrize('variable', [False, True])
def test_pitch_bin_conversions_match_jax(variable, monkeypatch):
    monkeypatch.setattr(promonet_tpu, 'VARIABLE_PITCH_BINS', variable)
    config = CONFIG.replace(VARIABLE_PITCH_BINS=variable)
    rng = np.random.default_rng(4)
    distribution = np.sort(rng.uniform(50., 550., 256)).astype(np.float32)
    bins = rng.integers(0, 256, 300).astype(np.int32)
    hz = rng.uniform(20., 800., 300).astype(np.float32)
    np.testing.assert_array_equal(
        port.convert.hz_to_bins(
            torch.from_numpy(hz), pitch_distribution=distribution,
            config=config).numpy(),
        jax_convert.hz_to_bins(hz, pitch_distribution=distribution))
    np.testing.assert_allclose(
        port.convert.bins_to_hz(
            torch.from_numpy(bins), pitch_distribution=distribution,
            config=config).numpy(),
        jax_convert.bins_to_hz(bins, pitch_distribution=distribution),
        rtol=1e-6)
    # Explicit ranges and counts
    np.testing.assert_array_equal(
        port.convert.hz_to_bins(
            torch.from_numpy(hz), 64, 70., 500., distribution[:64],
            config=config).numpy(),
        jax_convert.hz_to_bins(hz, 64, 70., 500., distribution[:64]))


def test_loudness_and_time_conversions_match_jax():
    db = np.linspace(-20., 20., 41).astype(np.float32)
    np.testing.assert_allclose(
        port.convert.db_to_ratio(torch.from_numpy(db)).numpy(),
        jax_convert.db_to_ratio(jnp.asarray(db)), rtol=1e-6)
    assert port.convert.db_to_ratio(3.) == jax_convert.db_to_ratio(3.)
    ratio = np.linspace(.25, 4., 31).astype(np.float32)
    for ours, theirs in ((port.convert.ratio_to_db, jax_convert.ratio_to_db),
                         (port.convert.ratio_to_cents,
                          jax_convert.ratio_to_cents)):
        np.testing.assert_allclose(
            ours(torch.from_numpy(ratio)).numpy(),
            theirs(jnp.asarray(ratio)), rtol=1e-6, atol=1e-5)
        assert ours(1.5) == theirs(1.5)
    for seconds in (0., 0.01, 1., 2.85, 10.):
        assert port.convert.seconds_to_frames(seconds) == \
            jax_convert.seconds_to_frames(seconds)
    for frames in (0, 1, 86, 861):
        assert port.convert.frames_to_samples(frames) == \
            jax_convert.frames_to_samples(frames)
        assert port.convert.frames_to_seconds(frames) == \
            jax_convert.frames_to_seconds(frames)
    for samples in (0, 255, 256, 22050, 220501):
        assert port.convert.samples_to_frames(samples) == \
            jax_convert.samples_to_frames(samples)
        assert port.convert.samples_to_seconds(samples) == \
            jax_convert.samples_to_seconds(samples)
        assert port.convert.samples_to_seconds(samples, 16000) == \
            jax_convert.samples_to_seconds(samples, 16000)
    assert port.convert.samples_to_frames(1000, config=CONFIG.replace(
        HOPSIZE=100)) == 10


def test_grid_from_alignments_matches_jax():
    rng = np.random.default_rng(5)

    def alignment(count):
        ends = np.cumsum(rng.uniform(0.02, 0.3, count))
        return np.stack([np.concatenate([[0.], ends[:-1]]), ends], axis=1)

    source, target = alignment(12), alignment(12)
    target[3] = [target[3, 0], target[3, 0]]  # an empty target phoneme
    theirs = np.asarray(jax_edit_grid.from_alignments(source, target))
    ours = port.edit.grid.from_alignments(source, target, device='cpu')
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        port.ops.grid.from_alignments(
            source, target, 16000, 160, 'cpu').numpy(),
        np.asarray(jax_grid.from_alignments(source, target, 16000, 160)))
    with pytest.raises(ValueError):
        port.ops.grid.from_alignments(
            source, target[:5], 22050, 256, 'cpu')


def test_receptive_field_matches_jax():
    assert port.models.hifigan.receptive_field_frames() == \
        jax_hifigan.receptive_field_frames() == 28
    arguments = ((8, 8, 4), (4, 4, 2), (3, 5), ((1, 2), (1, 3, 9)))
    assert port.models.hifigan.receptive_field_frames(*arguments) == \
        jax_hifigan.receptive_field_frames(*arguments)


def test_model_is_the_models_alias():
    assert port.model is port.models
    assert promonet_tpu.model is promonet_tpu.models


def test_get_padding_matches_jax():
    for kernel_size in range(1, 12):
        for dilation in range(1, 6):
            for stride in (1, 2):
                assert port.models.get_padding(
                    kernel_size, dilation, stride) == \
                    promonet_tpu.models.get_padding(
                        kernel_size, dilation, stride)
    assert port.models.get_padding(7, 3) == 9


@pytest.mark.parametrize('n, keep_size', [
    (64, False), (64, True), (513, False), (513, True)])
def test_gen_filterbank_matches_jax(n, keep_size):
    theirs = np.asarray(promonet_tpu.models.discriminator.gen_filterbank(
        n, 22050, keep_size))
    ours = port.models.discriminator.gen_filterbank(n, 22050, keep_size)
    assert ours.dtype == torch.float32
    assert ours.shape == (n + keep_size, n + 1)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_profile_writes_a_trace(tmp_path):
    """`utils.timer.profile` leaves a Chrome trace of the region's
    operations under the directory"""
    with port.utils.timer.profile(tmp_path / 'trace'):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    traces = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())['traceEvents']
    assert any('matmul' in event.get('name', '') for event in events)


@pytest.mark.parametrize('frames', [1, 7, 120])
def test_viterbi_from_probabilities_matches_jax(frames):
    rng = np.random.default_rng(frames)
    observation = rng.random((frames, 32)).astype(np.float32)
    observation[:, 5] = 0.  # clipped to 1e-12 before the log
    theirs = np.asarray(jax_viterbi.from_probabilities(observation))
    ours = port.ops.viterbi.from_probabilities(torch.from_numpy(observation))
    np.testing.assert_array_equal(ours.numpy(), theirs)

    transition = rng.random((32, 32)).astype(np.float32)
    transition /= transition.sum(axis=1, keepdims=True)
    initial = rng.random(32).astype(np.float32)
    theirs = np.asarray(jax_viterbi.from_probabilities(
        observation, transition, initial))
    ours = port.ops.viterbi.from_probabilities(
        torch.from_numpy(observation), torch.from_numpy(transition),
        torch.from_numpy(initial))
    np.testing.assert_array_equal(ours.numpy(), theirs)


###############################################################################
# Per-speaker averages
###############################################################################


def test_per_speaker_averages_match_jax(tmp_path, monkeypatch):
    """A dataset of pitch and periodicity files and its partition, for
    both packages; the port writes its statistics under the data tree"""
    rng = np.random.default_rng(6)
    cache = tmp_path / 'cache' / 'toy'
    stems = {'train': [], 'valid': []}
    for speaker in ('0000', '0001'):
        (cache / speaker).mkdir(parents=True)
        for index in range(4):
            stem = f'{speaker}/{index:06d}-100'
            stems['train' if index else 'valid'].append(stem)
            pitch = rng.uniform(70., 400., (1, 50)).astype(np.float32)
            pitch[0, rng.random(50) < 0.1] = np.nan
            np.save(cache / f'{stem}-viterbi-pitch.npy', pitch)
            np.save(cache / f'{stem}-viterbi-periodicity.npy',
                    rng.random((1, 50)).astype(np.float32))
    for directory in (tmp_path / 'assets' / 'partitions' / 'multispeaker',
                      tmp_path / 'partitions' / 'multispeaker'):
        directory.mkdir(parents=True)
        (directory / 'toy.json').write_text(json.dumps(stems))
    monkeypatch.setattr(promonet_tpu, 'CACHE_DIR', tmp_path / 'cache')
    monkeypatch.setattr(promonet_tpu, 'ASSETS_DIR', tmp_path / 'assets')
    monkeypatch.setattr(promonet_tpu, 'AUGMENT_DIR', tmp_path / 'none')
    config = CONFIG.replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        AUGMENT_DIR=tmp_path / 'none', ASSETS_DIR=tmp_path / 'assets')

    theirs = promonet_tpu.load.per_speaker_averages('toy')
    ours = port.load.per_speaker_averages('toy', config=config)
    assert ours == theirs and set(ours) == {'0000', '0001'}
    written = tmp_path / 'stats' / 'toy-train-speaker-averages-viterbi.json'
    assert json.loads(written.read_text()) == ours
    # Read back from its file, not computed again
    written.write_text(json.dumps({'0000': 1.}))
    assert port.load.per_speaker_averages('toy', config=config) == {
        '0000': 1.}
    assert port.load.per_speaker_averages(
        'toy', 'valid', config=config).keys() == ours.keys()


###############################################################################
# The JAX package's defaults and parameters
###############################################################################


def test_loudness_default_is_the_band_mean():
    audio = _speech(4096)
    theirs = np.asarray(jax_loudness.from_audio(audio))
    ours = port.preprocess.loudness.from_audio(torch.from_numpy(audio))
    assert ours.shape == theirs.shape == (1, 1 + (4096 - 256) // 256)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=2e-3)


@pytest.mark.parametrize('max_harmonics', [None, 2])
def test_harmonics_viterbi_takes_max_harmonics_from_the_config(
        max_harmonics, monkeypatch):
    from test_torch_harmonics import _decode_problem

    spectra, frequencies = _decode_problem()
    config = CONFIG
    if max_harmonics is not None:
        config = CONFIG.replace(MAX_HARMONICS=max_harmonics)
        monkeypatch.setattr(promonet_tpu, 'MAX_HARMONICS', max_harmonics)
    theirs = jax_harmonics.viterbi(spectra, frequencies)
    ours = port.preprocess.harmonics.viterbi(
        torch.from_numpy(spectra), frequencies, config=config).numpy()
    assert ours.shape == theirs.shape == (config.MAX_HARMONICS, 40)
    np.testing.assert_array_equal(ours, theirs)
    if max_harmonics is None:
        np.testing.assert_array_equal(port.preprocess.harmonics.viterbi(
            torch.from_numpy(spectra), frequencies).numpy(), theirs)


@pytest.mark.parametrize('fmin,fmax', [(0., None), (50., None), (0., 8000.),
                                       (80., 7600.)])
def test_mel_filterbank_band_matches_jax(fmin, fmax):
    ours = port.ops.mel.mel_filterbank(22050, 1024, 80, fmin, fmax)
    theirs = np.asarray(jax_mel.mel_filterbank(22050, 1024, 80, fmin, fmax))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert np.array_equal(
        ours, port.ops.mel.mel_filterbank(22050, 1024, 80)) == (
        (fmin, fmax) == (0., None))


@pytest.mark.parametrize('magnitude', [False, True])
def test_centred_stft_matches_jax(magnitude):
    audio = _speech(5000)[0]
    ours = stft.stft(torch.from_numpy(audio), 1024, 256,
                     window=stft.hann_window(1024), center=True,
                     magnitude=magnitude).numpy()
    theirs = np.asarray(jax_stft.stft(
        jnp.asarray(audio), 1024, 256, window=jax_stft.hann_window(1024),
        center=True, magnitude=magnitude))
    assert ours.shape == theirs.shape == (513, 1 + 5000 // 256)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())
