"""The port's harmonics path held against the JAX package's.

Inputs are made with numpy from a seed and go through both packages.
The Viterbi decodes only add and compare, so their paths must be equal
exactly, ties, -inf bands and NaN frames included; the JAX Pallas kernel
runs in interpret mode as the JAX package's own tests run it. The CUDA
kernel cannot run here: its algorithm (the band table, the floor
candidate, the smaller index on equal values) is emulated in numpy and
held against the dense scan. Host-side numpy and scipy steps are
bit-equal; float32 FFTs, cumulative sums and logs of torch and XLA
differ in rounding, with the tolerances stated at each comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import promonet_tpu
from promonet_tpu.ops import viterbi as jax_viterbi
from promonet_tpu.preprocess import harmonics as jax_harmonics
from promonet_tpu.utils import audio as jax_audio

import promonet_tpu_torch as port
from promonet_tpu_torch.ops import viterbi
from promonet_tpu_torch.preprocess import harmonics

FREQUENCIES = np.linspace(50., 8000., 200)


def _initial(num_states):
    ramp = np.linspace(1., .01, num_states)
    return np.log(ramp / ramp.sum()).astype(np.float32)


def _problem(kind, **kwargs):
    """(observation, initial) of one kind; 'binade' needs a flat initial"""
    if kind == 'binade':
        return _observation(kind, seed=4), np.zeros(200, np.float32)
    observation = _observation(kind, **kwargs)
    return observation, _initial(observation.shape[1])


def _observation(kind, frames=70, states=200, seed=3):
    rng = np.random.default_rng(seed)
    if kind == 'random':
        logits = 3. * rng.standard_normal((frames, states))
        return np.array(jax.nn.log_softmax(
            jnp.asarray(logits, jnp.float32), axis=-1))
    if kind == 'ties':
        # A few distinct values: many exactly tied scores in every frame
        observation = np.round(rng.standard_normal((frames, states)))
        observation[10:20] = 0.
        return observation.astype(np.float32)
    if kind == 'masked':
        # -inf outside a band that moves from frame to frame
        logits = 3. * rng.standard_normal((frames, states))
        low = rng.integers(0, states - 30, frames)
        columns = np.arange(states)[None]
        band = (columns >= low[:, None]) & (columns < low[:, None] + 25)
        return np.array(jax.nn.log_softmax(
            jnp.where(band, jnp.asarray(logits, jnp.float32), -jnp.inf),
            axis=-1))
    if kind == 'nan':
        # A frame with an empty band: its log-softmax is all NaN
        observation = _observation('masked', frames, states, seed)
        observation[frames // 2] = np.nan
        return observation
    if kind == 'binade':
        # A few likely sources with alphas 1 to 3 float32 steps below
        # -4090, and a jump out of their band in the next frame: adding
        # the floor crosses into the next binade and rounds the alphas 1
        # and 2 steps below to one sum, where the dense scan keeps the
        # first of either and not the first of the largest alpha
        observation = np.zeros((frames, states), np.float32)
        observation[0] = -4300.
        likely = np.arange(40, 52)
        observation[0, likely] = (
            np.float32(-4090.) -
            rng.integers(1, 4, len(likely)) * np.float32(2. ** -12))
        observation[1:] = np.round(rng.standard_normal((frames - 1, states)))
        observation[1, 150] = 200.
        return observation
    raise ValueError(kind)


def _jax_dense(observation, frequencies, initial):
    return np.asarray(jax_viterbi.decode_logfreq(
        jnp.asarray(observation), frequencies, jnp.asarray(initial),
        use_pallas=False))


def _ours(observation, frequencies, initial):
    return viterbi.decode_logfreq(
        torch.from_numpy(observation), frequencies,
        torch.from_numpy(initial)).numpy()


def _banded(observation, frequencies, initial):
    """Path of the CUDA kernel's algorithm: forward pass, then backtrace"""
    predecessors, alpha = _banded_forward(observation, frequencies, initial)
    path = np.empty(len(predecessors), np.int32)
    path[-1] = int(np.argmax(alpha))
    for t in range(len(predecessors) - 1, 0, -1):
        path[t - 1] = predecessors[t, path[t]]
    return path


def _banded_forward(observation, frequencies, initial):
    """The CUDA kernel's forward pass in numpy: (predecessors, final alpha)

    Per destination: the first maximum over its run of the band table,
    against the floor candidate (first maximum over all sources of
    alpha + floor); the larger value wins and equal values take the
    smaller index. A NaN in alpha is every destination's maximum.
    """
    values, offsets, lows, floor = viterbi.band_table(frequencies)
    num_frames, num_states = observation.shape
    lengths = np.diff(offsets)
    column = np.repeat(np.arange(num_states), lengths)
    source = np.arange(len(values)) - offsets[column] + lows[column]
    predecessors = np.zeros((num_frames, num_states), np.int32)
    alpha = initial + observation[0]
    for t in range(1, num_frames):
        with np.errstate(invalid='ignore'):
            floored = alpha + floor
        floor_index = int(np.argmax(floored))
        floor_value = floored[floor_index]
        if np.isnan(floor_value):
            predecessors[t] = floor_index
            alpha = floor_value + observation[t]
            continue
        scores = alpha[source] + values
        best = np.maximum.reduceat(scores, offsets[:-1])
        first = np.minimum.reduceat(
            np.where(scores == best[column], source, num_states),
            offsets[:-1])
        take_floor = (floor_value > best) | (
            (floor_value == best) & (floor_index < first))
        predecessors[t] = np.where(take_floor, floor_index, first)
        with np.errstate(invalid='ignore'):
            alpha = np.where(take_floor, floor_value, best) + observation[t]
    return predecessors, alpha


###############################################################################
# ops/viterbi.py: the log-frequency decode
###############################################################################


@pytest.mark.parametrize('locality', [3.5, 1.])
def test_logfreq_transition_dense_matches_jax(locality):
    for frequencies in (FREQUENCIES, FREQUENCIES.astype(np.float32)[:37]):
        np.testing.assert_array_equal(
            viterbi.logfreq_transition_dense(frequencies, locality).numpy(),
            np.asarray(jax_viterbi.logfreq_transition_dense(
                frequencies, locality)))


@pytest.mark.parametrize('kind', ['random', 'ties', 'masked', 'nan', 'binade'])
def test_decode_logfreq_matches_jax_dense(kind):
    observation, initial = _problem(kind)
    ours = _ours(observation, FREQUENCIES, initial)
    assert ours.dtype == np.int32 and ours.shape == (70,)
    np.testing.assert_array_equal(
        ours, _jax_dense(observation, FREQUENCIES, initial))


def _jax_pallas(observation, frequencies, initial):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_viterbi.decode_logfreq(
            jnp.asarray(observation), frequencies, jnp.asarray(initial),
            use_pallas=True, time_chunk=16))


def test_decode_logfreq_matches_pallas_kernel():
    observation, initial = _problem('random')
    np.testing.assert_array_equal(
        _ours(observation, FREQUENCIES, initial),
        _jax_pallas(observation, FREQUENCIES, initial))


def test_pallas_floor_candidate_differs_where_the_floor_sum_rounds():
    """A property of the reference, recorded and not copied

    The Pallas kernel takes its floor candidate from the first maximum
    of alpha; the dense scan (and the port) from the first maximum of
    alpha + floor, which can round two alphas to one sum. On the
    'binade' input the two JAX paths start in different states; the
    port follows the dense scan.
    """
    observation, initial = _problem('binade')
    dense = _jax_dense(observation, FREQUENCIES, initial)
    pallas = _jax_pallas(observation, FREQUENCIES, initial)
    assert dense[0] == 43 and pallas[0] == 47
    np.testing.assert_array_equal(dense[1:], pallas[1:])
    np.testing.assert_array_equal(
        _ours(observation, FREQUENCIES, initial), dense)


def test_decode_logfreq_one_frame_and_no_launch_on_cpu():
    observation, initial = _problem('random', frames=1)
    before = viterbi.decode_logfreq.launches
    ours = _ours(observation, FREQUENCIES, initial)
    assert viterbi.decode_logfreq.launches == before
    assert ours.shape == (1,)
    assert ours[0] == np.argmax(initial + observation[0])
    np.testing.assert_array_equal(
        ours, _jax_dense(observation, FREQUENCIES, initial))


def test_band_table_carries_the_dense_matrix():
    values, offsets, lows, floor = viterbi.band_table(FREQUENCIES)
    dense = viterbi.logfreq_transition_dense(FREQUENCIES).numpy()
    rebuilt = np.full_like(dense, floor)
    for j in range(200):
        run = values[offsets[j]:offsets[j + 1]]
        rebuilt[lows[j]:lows[j] + len(run), j] = run
    np.testing.assert_array_equal(rebuilt, dense)
    assert floor == np.float32(np.log(1e-12)) and (dense >= floor).all()
    assert values.dtype == np.float32 and offsets.dtype == np.int32
    # The diagonal is always inside its run
    assert (lows <= np.arange(200)).all()
    assert (lows + np.diff(offsets) > np.arange(200)).all()


@pytest.mark.parametrize('blocks', [1, 7, 132, 500])
def test_partition_covers_every_destination_once(blocks):
    _, offsets, _, _ = viterbi.band_table(FREQUENCIES)
    starts = viterbi.partition_destinations(offsets, blocks)
    assert starts.shape == (blocks + 1,) and starts.dtype == np.int32
    assert starts[0] == 0 and starts[-1] == 200
    assert (np.diff(starts) >= 0).all()


@pytest.mark.parametrize('kind', ['random', 'ties', 'masked', 'nan', 'binade'])
def test_banded_algorithm_matches_dense_scan(kind):
    """What the CUDA kernel computes, emulated: equal to the dense scan

    Predecessors and final alpha are compared, not only the path, so a
    destination off the best path counts too.
    """
    observation, initial = _problem(kind)
    predecessors, alpha = _banded_forward(observation, FREQUENCIES, initial)
    expected, expected_alpha = viterbi.forward_plain(
        torch.from_numpy(observation),
        viterbi.logfreq_transition_dense(FREQUENCIES),
        torch.from_numpy(initial))
    np.testing.assert_array_equal(predecessors, expected.numpy())
    np.testing.assert_array_equal(alpha, expected_alpha.numpy())
    np.testing.assert_array_equal(
        _banded(observation, FREQUENCIES, initial),
        _ours(observation, FREQUENCIES, initial))


def test_banded_algorithm_on_a_flat_and_an_impossible_input():
    initial = _initial(200)
    flat = np.zeros((9, 200), np.float32)
    np.testing.assert_array_equal(
        _banded(flat, FREQUENCIES, initial), _ours(flat, FREQUENCIES, initial))
    impossible = np.full((5, 200), -np.inf, np.float32)
    np.testing.assert_array_equal(
        _banded(impossible, FREQUENCIES, initial),
        _ours(impossible, FREQUENCIES, initial))
    np.testing.assert_array_equal(
        _ours(impossible, FREQUENCIES, initial), 0)


@pytest.mark.slow
def test_decode_logfreq_at_the_main_path_width():
    frequencies = harmonics.stft_features(
        np.zeros((1, 8192), np.float32), config=port.config.load(),
        device='cpu')[1]
    assert frequencies.shape == (2039,)
    observation = _observation('random', frames=24, states=2039, seed=4)
    initial = _initial(2039)
    ours = _ours(observation, frequencies, initial)
    np.testing.assert_array_equal(
        ours, _jax_dense(observation, frequencies, initial))
    np.testing.assert_array_equal(
        ours, _banded(observation, frequencies, initial))


###############################################################################
# utils/audio.py and preprocess/harmonics.py
###############################################################################


def _speechlike(seconds=0.6, seed=0):
    """Five harmonics of a gliding 140–220 Hz fundamental plus noise"""
    rng = np.random.default_rng(seed)
    sr = promonet_tpu.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140. + 80. * t / t[-1]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    audio = sum((0.6 ** k) * np.sin(k * phase) for k in range(1, 6))
    audio = audio + 0.01 * rng.standard_normal(t.shape)
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


@pytest.mark.parametrize('source,target', [
    (44100, 22050), (16000, 22050), (22050, 22050), (22051, 22050)])
def test_resample_is_bit_equal(source, target):
    audio = _speechlike(0.2)
    ours = port.utils.audio.resample(audio, source, target)
    theirs = jax_audio.resample(audio, source, target)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_highpass_biquad_is_bit_equal():
    audio = _speechlike(0.2)
    ours = harmonics.highpass_biquad(audio, 22050, 66.5)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, jax_harmonics.highpass_biquad(audio, 22050, 66.5))


@pytest.mark.parametrize('fmax', [None, 4000])
def test_stft_features_match_jax(fmax):
    audio = _speechlike()
    frames, frequencies = harmonics.stft_features(
        audio, fmax=fmax, config=port.config.load(), device='cpu')
    theirs, their_frequencies = jax_harmonics.stft_features(audio, fmax=fmax)
    theirs = np.asarray(theirs)
    assert frames.dtype == torch.float32 and frequencies.dtype == np.float32
    assert tuple(frames.shape) == theirs.shape
    if fmax is None:
        assert tuple(frames.shape) == (audio.shape[-1] // 256, 2039)
    np.testing.assert_array_equal(frequencies, np.asarray(their_frequencies))
    # float32 FFTs of 4096 points: 1e-4 of the peak magnitude
    np.testing.assert_allclose(
        frames.numpy(), theirs, rtol=0, atol=1e-4 * theirs.max())


def test_lpc_coefficients_match_jax():
    audio = _speechlike(0.3)
    frames, frequencies = harmonics.lpc_coefficients(
        audio, config=port.config.load(), device='cpu')
    theirs, their_frequencies = jax_harmonics.lpc_coefficients(audio)
    np.testing.assert_array_equal(frequencies, np.asarray(their_frequencies))
    # Host numpy and scipy on both sides: the same float32 values
    np.testing.assert_array_equal(frames.numpy(), np.asarray(theirs))
    autocorrelation = np.array([4., 2., 1., .5])
    np.testing.assert_array_equal(
        harmonics._levinson_durbin(autocorrelation, 3),
        jax_harmonics._levinson_durbin(autocorrelation, 3))


def test_pitch_posteriorgram_matches_jax():
    audio = _speechlike(0.3)
    frames, frequencies = harmonics.pitch_posteriorgram(
        audio, config=port.config.load(), device='cpu')
    theirs, their_frequencies = jax_harmonics.pitch_posteriorgram(audio)
    np.testing.assert_array_equal(frequencies, np.asarray(their_frequencies))
    assert tuple(frames.shape) == np.asarray(theirs).shape == (25, 512)
    # Correlations in [-1, 1]; float32 FFTs and a float32 running sum of
    # 950 squares, summed in another order by XLA
    np.testing.assert_allclose(
        frames.numpy(), np.asarray(theirs), rtol=0, atol=1e-4)


def _decode_problem(seed=5, frames=40, states=200):
    rng = np.random.default_rng(seed)
    spectra = np.abs(rng.standard_normal((frames, states))).astype(np.float32)
    # A ridge near bin 20 and its multiples, as harmonics would leave
    track = 20 + np.round(3 * np.sin(np.arange(frames) / 6.)).astype(int)
    for k in (1, 2, 3):
        spectra[np.arange(frames), np.minimum(k * track, states - 1)] += \
            40. / k
    frequencies = np.linspace(50., 8000., states).astype(np.float32)
    return spectra, frequencies


@pytest.mark.parametrize('given_pitch', [False, True])
def test_harmonics_viterbi_matches_jax(given_pitch):
    spectra, frequencies = _decode_problem()
    pitch = None
    if given_pitch:
        pitch = frequencies[20] * np.ones((1, 40), np.float32)
        # Bands above the axis are empty: an all-NaN frame for harmonic 1
        # (from frame 30) and for harmonic 2 (from frame 25)
        pitch[0, 25:] = 3000.
        pitch[0, 30:] = 6500.
    theirs = jax_harmonics.viterbi(spectra, frequencies, pitch)
    ours = harmonics.viterbi(
        torch.from_numpy(spectra), frequencies,
        None if pitch is None else torch.from_numpy(pitch)).numpy()
    assert ours.shape == theirs.shape == (3, 40) and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    np.testing.assert_array_equal(ours, theirs)
    if not given_pitch:
        track = 20 + np.round(3 * np.sin(np.arange(40) / 6.)).astype(int)
        np.testing.assert_array_equal(ours[0], frequencies[track])


@pytest.mark.parametrize('kinds', [
    ('random', 'nan'), ('ties', 'masked', 'random'), ('nan', 'nan')])
def test_decode_logfreq_batch_matches_jax_dense(kinds):
    """A (B, T, N) batch on the CPU is B single decodes"""
    problems = [_problem(kind) for kind in kinds]
    initial = problems[0][1]
    batch = np.stack([observation for observation, _ in problems])
    ours = _ours(batch, FREQUENCIES, initial)
    assert ours.shape == (len(kinds), 70) and ours.dtype == np.int32
    for path, observation in zip(ours, batch):
        np.testing.assert_array_equal(
            path, _jax_dense(observation, FREQUENCIES, initial))
        np.testing.assert_array_equal(
            path, _ours(observation, FREQUENCIES, initial))


def test_decode_logfreq_batch_keeps_the_binade_case():
    observation, initial = _problem('binade')
    batch = np.stack([observation, observation[::-1].copy()])
    ours = _ours(batch, FREQUENCIES, initial)
    assert ours[0, 0] == 43
    for path, sequence in zip(ours, batch):
        np.testing.assert_array_equal(
            path, _jax_dense(sequence, FREQUENCIES, initial))


@pytest.mark.parametrize('given_pitch', [False, True])
@pytest.mark.parametrize('max_harmonics', [1, 2, 3, 5])
def test_harmonics_viterbi_batches_the_decodes_above_f0(
    given_pitch, max_harmonics, monkeypatch
):
    """One decode for F0 unless it is given, one batch for all the rest,
    and the same contours as the JAX package's loop"""
    spectra, frequencies = _decode_problem()
    pitch = frequencies[20] * np.ones((1, 40), np.float32) \
        if given_pitch else None
    shapes = []
    decode_logfreq = viterbi.decode_logfreq

    def counting(observation, *args, **kwargs):
        shapes.append(tuple(observation.shape))
        return decode_logfreq(observation, *args, **kwargs)

    monkeypatch.setattr(viterbi, 'decode_logfreq', counting)
    ours = harmonics.viterbi(
        torch.from_numpy(spectra), frequencies,
        None if pitch is None else torch.from_numpy(pitch),
        max_harmonics=max_harmonics).numpy()
    expected = ([] if given_pitch else [(40, 200)]) + (
        [(max_harmonics - 1, 40, 200)] if max_harmonics > 1 else [])
    assert shapes == expected
    theirs = jax_harmonics.viterbi(
        spectra, frequencies, pitch, max_harmonics=max_harmonics)
    assert ours.shape == theirs.shape == (max_harmonics, 40)
    np.testing.assert_array_equal(ours, theirs)


def test_harmonics_viterbi_initial_is_within_float32_rounding():
    """torch and XLA round linspace and log differently: a few ulps"""
    ramp = torch.linspace(1., 0., 200)
    ours = torch.log(torch.clamp(ramp / ramp.sum(), min=1e-12)).numpy()
    theirs = jnp.linspace(1., 0., 200)
    theirs = np.asarray(jnp.log(jnp.clip(theirs / theirs.sum(), 1e-12)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


def test_peak_pick_matches_jax():
    spectra, frequencies = _decode_problem(frames=12)
    spectra[3] = 0.  # no peak: NaN contours
    theirs = jax_harmonics.peak_pick(spectra, frequencies, 3)
    ours = harmonics.peak_pick(torch.from_numpy(spectra), frequencies, 3)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert np.isnan(ours[:, 3].numpy()).all()


@pytest.mark.parametrize('features,decoder', [
    ('stft', 'viterbi'), ('stft', 'peak'), ('lpc', 'viterbi'),
    ('posteriorgram', 'viterbi')])
def test_harmonics_from_audio_matches_jax(features, decoder):
    audio = _speechlike()
    theirs, their_features = jax_harmonics.from_audio(
        audio, features=features, decoder=decoder, return_features=True)
    ours, our_features = harmonics.from_audio(
        audio, features=features, decoder=decoder, return_features=True,
        config=port.config.load(), device='cpu')
    assert tuple(ours.shape) == theirs.shape == (3, audio.shape[-1] // 256)
    assert tuple(our_features.shape) == np.asarray(their_features).shape
    # The contours are bin frequencies: equal wherever the paths are.
    # Analysis features differ in float32 rounding, which can move a
    # near-tied frame by a bin; none does on this input
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_harmonics_from_audio_rejects_unknown_names():
    audio = _speechlike(0.1)
    with pytest.raises(ValueError, match='features'):
        harmonics.from_audio(audio, features='mel', device='cpu')
    with pytest.raises(ValueError, match='decoder'):
        harmonics.from_audio(audio, decoder='greedy', device='cpu')


def test_preprocess_from_audio_orders_harmonics_last():
    audio = _speechlike(0.3)
    config = port.config.load().replace(PITCH_ESTIMATOR='dsp')
    ppg_model = port.models.init.seeded(port.preprocess.PPGEncoder(), 2)
    frames = audio.shape[-1] // 256
    loudness, pitch, harmonic = port.preprocess.from_audio(
        audio, None, ppg_model, features=('harmonics', 'pitch', 'loudness'),
        config=config, device='cpu')
    # Returned in the package's order, whatever order was asked
    assert tuple(loudness.shape) == (8, frames)
    assert tuple(pitch.shape) == (1, frames)
    assert tuple(harmonic.shape) == (3, frames)
    theirs = promonet_tpu.preprocess.from_audio(
        audio, features=('loudness', 'harmonics'))
    np.testing.assert_array_equal(harmonic.numpy(), theirs[1])
    only, = port.preprocess.from_audio(
        audio, None, None, features=('harmonics',), max_harmonics=2,
        config=config, device='cpu')
    np.testing.assert_array_equal(only.numpy(), theirs[1][:2])
    # 'spectrogram' is ported (tests/test_torch_mels.py); 'text' is not a
    # feature of the port's from_audio (preprocess.text transcribes)
    with pytest.raises(NotImplementedError, match='text'):
        port.preprocess.from_audio(
            audio, None, None, features=('text',), device='cpu')
