"""WORLD DSP vocoder baseline (counterpart of `promonet_tpu/baseline/world.py`)

The port's own copy of the JAX package's WORLD analysis and synthesis,
which it computes in float64 numpy on the host, as the JAX package does:
this is a comparison baseline, not a path of the card. The same input
gives the JAX package's output exactly, its synthesis noise included
(`np.random.default_rng(0)`).

- `_dio`: multi-band low-pass filtering with windowed-sinc filters at
  half-octave boundary frequencies; four interval-based F0 estimates
  per band (rising/falling zero crossings, peaks, dips); the candidate
  with the lowest relative deviation wins; contour fixing removes
  unstable frames, short voiced runs, and octave jumps
  (ALLOWED_RANGE = .8).
- `_stonemask`: refinement by instantaneous frequency, Flanagan's
  phase-derivative identity with a Blackman analysis window and its
  discrete derivative, averaged over harmonics weighted by amplitude.
- `_cheaptrick`: pitch-adaptive Hanning window (3 periods), power
  spectrum, rectangular frequency smoothing of width 2/3 F0, and
  cepstral liftering (sinc smoothing lifter and q1 = -0.15
  compensation).
- `_d4c`: band aperiodicity per 3 kHz band from the inter-harmonic
  against harmonic power of a 4-period windowed spectrum, interpolated
  in dB across frequency.
- `synthesize`: impulse-train and white-noise excitation, split per
  frequency bin by the aperiodicity and filtered by the spectral
  envelope with windowed overlap-add.

Edits: a pitch shift replaces F0, a time stretch interpolates the WORLD
parameters along a grid (F0 in log space), and loudness is matched after
synthesis (`preprocess.loudness.scale`).
"""
import numpy as np

from .. import config as config_module

# DIO's allowed range of relative deviation
ALLOWED_RANGE = .8

# CheapTrick liftering coefficient and unvoiced analysis F0 (WORLD's
# kDefaultF0); D4C coarse-band spacing in Hz
Q1 = -0.15
DEFAULT_F0 = 500.
FREQUENCY_INTERVAL = 3000.


###############################################################################
# DIO
###############################################################################


def _nuttall(n):
    t = np.arange(n) / max(n - 1, 1)
    return (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t))


def _low_pass(audio, fs, cutoff):
    """Zero-phase windowed-sinc low-pass at `cutoff` Hz"""
    half = int(round(fs / cutoff)) * 2
    n = np.arange(-half, half + 1)
    taps = np.sinc(2 * cutoff / fs * n) * _nuttall(2 * half + 1)
    taps /= taps.sum()
    spectrum_len = len(audio) + len(taps) - 1
    # FFT convolution, centered (zero phase)
    result = np.fft.irfft(
        np.fft.rfft(audio, spectrum_len) * np.fft.rfft(taps, spectrum_len),
        spectrum_len)
    return result[half:half + len(audio)]


def _interval_estimate(times, frame_times):
    """Interval-based F0 estimate interpolated onto frame times

    `times` are event locations in seconds; each interval contributes
    1/interval at its midpoint. Frames outside the event span get 0.
    """
    if len(times) < 2:
        return np.zeros(len(frame_times))
    intervals = np.diff(times)
    valid = intervals > 0
    if valid.sum() < 1:
        return np.zeros(len(frame_times))
    mids = (0.5 * (times[1:] + times[:-1]))[valid]
    f0s = 1. / intervals[valid]
    estimate = np.interp(frame_times, mids, f0s)
    estimate[(frame_times < mids[0]) | (frame_times > mids[-1])] = 0.
    return estimate


def _zero_crossings(y, fs, rising):
    sign = y > 0 if rising else y < 0
    idx = np.nonzero(sign[1:] & ~sign[:-1])[0]
    if len(idx) == 0:
        return np.empty(0)
    denominator = y[idx] - y[idx + 1]
    frac = np.where(
        np.abs(denominator) > 1e-12, y[idx] / denominator, 0.5)
    return (idx + frac) / fs


def _dio(audio, fs, frame_times, f0_floor, f0_ceil, allowed_range):
    """DIO F0 estimation (pyworld.dio semantics)

    Returns (f0, score) per frame; score is the relative deviation of
    the four interval estimates (lower = more reliable).
    """
    audio = audio - audio.mean()
    num_bands = int(np.ceil(2 * np.log2(f0_ceil / f0_floor)))
    boundaries = f0_floor * 2 ** ((np.arange(num_bands) + 1) / 2.)

    num_frames = len(frame_times)
    best_f0 = np.zeros(num_frames)
    best_score = np.full(num_frames, np.inf)

    for boundary in boundaries:
        filtered = _low_pass(audio, fs, boundary)
        derivative = np.diff(filtered, append=filtered[-1])
        estimates = np.stack([
            _interval_estimate(
                _zero_crossings(filtered, fs, True), frame_times),
            _interval_estimate(
                _zero_crossings(filtered, fs, False), frame_times),
            _interval_estimate(
                _zero_crossings(derivative, fs, False), frame_times),
            _interval_estimate(
                _zero_crossings(derivative, fs, True), frame_times),
        ])
        candidate = estimates.mean(axis=0)
        with np.errstate(invalid='ignore', divide='ignore'):
            score = estimates.std(axis=0) / np.maximum(candidate, 1e-9)
        valid = (
            (estimates > 0).all(axis=0)
            & (candidate >= f0_floor) & (candidate <= f0_ceil)
            & (candidate >= boundary / 2.) & (candidate <= boundary * 2.))
        score = np.where(valid, score, np.inf)
        better = score < best_score
        best_f0 = np.where(better, candidate, best_f0)
        best_score = np.where(better, score, best_score)

    # Contour fixing: drop unstable frames, short voiced runs, jumps
    f0 = np.where(best_score <= allowed_range, best_f0, 0.)
    f0 = _remove_short_runs(f0, minimum=2)
    f0 = _fix_jumps(f0, allowed_range)
    return f0, best_score


def _remove_short_runs(f0, minimum):
    voiced = f0 > 0
    f0 = f0.copy()
    start = None
    for i in range(len(voiced) + 1):
        if i < len(voiced) and voiced[i]:
            if start is None:
                start = i
        elif start is not None:
            if i - start < minimum:
                f0[start:i] = 0.
            start = None
    return f0


def _fix_jumps(f0, allowed_range):
    """Zero frames whose step from a voiced neighbor exceeds the range"""
    f0 = f0.copy()
    for direction in (1, -1):
        previous = 0.
        indices = range(len(f0)) if direction == 1 else range(
            len(f0) - 1, -1, -1)
        for i in indices:
            if f0[i] > 0 and previous > 0:
                if abs(f0[i] - previous) / previous > allowed_range:
                    f0[i] = 0.
            previous = f0[i]
    return f0


###############################################################################
# StoneMask
###############################################################################


def _refine_frame(audio, fs, time, f0):
    """One instantaneous-frequency refinement of a single frame's F0"""
    half = int(round(1.5 * fs / f0))
    center = int(round(time * fs))
    start = center - half
    segment = np.zeros(2 * half + 1)
    lo, hi = max(start, 0), min(start + 2 * half + 1, len(audio))
    if hi <= lo:
        return f0
    segment[lo - start:hi - start] = audio[lo:hi]

    # Blackman window over 3 periods and its discrete derivative
    t = np.arange(-half, half + 1) / fs * f0 / 3.
    window = 0.42 + 0.5 * np.cos(2 * np.pi * t) + 0.08 * np.cos(
        4 * np.pi * t)
    diff_window = np.zeros_like(window)
    diff_window[1:-1] = -(window[2:] - window[:-2]) / 2.

    fft_size = int(2 ** np.ceil(np.log2(len(segment) + 1)))
    main = np.fft.rfft(segment * window, fft_size)
    diff = np.fft.rfft(segment * diff_window, fft_size)
    power = main.real ** 2 + main.imag ** 2

    bin_hz = fs / fft_size
    frequencies = np.arange(len(main)) * bin_hz
    with np.errstate(invalid='ignore', divide='ignore'):
        instantaneous = frequencies + (
            main.real * diff.imag - main.imag * diff.real
        ) / np.maximum(power, 1e-20) * fs / (2 * np.pi)

    harmonics = min(int(fs / 2 / f0), 6)
    if harmonics < 1:
        return f0
    bins = np.clip(
        np.round(np.arange(1, harmonics + 1) * f0 / bin_hz).astype(int),
        0, len(main) - 1)
    amplitudes = np.sqrt(power[bins])
    if amplitudes.sum() <= 0:
        return f0
    refined = float(
        (instantaneous[bins] / np.arange(1, harmonics + 1) *
         amplitudes).sum() / amplitudes.sum())
    return refined if refined > 0 else f0


def _stonemask(audio, fs, frame_times, f0, f0_floor, f0_ceil):
    """Refine the DIO contour (pyworld.stonemask semantics)"""
    refined = f0.copy()
    for i in range(len(f0)):
        if f0[i] <= 0:
            continue
        value = _refine_frame(audio, fs, frame_times[i], f0[i])
        value = _refine_frame(audio, fs, frame_times[i], value)
        if f0_floor <= value <= f0_ceil:
            refined[i] = value
        else:
            refined[i] = 0.
    return refined


###############################################################################
# CheapTrick
###############################################################################


def _windowed_segment(audio, fs, time, length):
    center = int(round(time * fs))
    start = center - length // 2
    segment = np.zeros(length)
    lo, hi = max(start, 0), min(start + length, len(audio))
    if hi > lo:
        segment[lo - start:hi - start] = audio[lo:hi]
    return segment


def _linear_smoothing(power, width_hz, fs, fft_size):
    """Rectangular smoothing of a one-sided power spectrum (WORLD's
    LinearSmoothing): boundary handling by mirroring at DC/Nyquist."""
    bins = len(power)
    bin_hz = fs / fft_size
    # Mirror-extend so the running integral is defined past the edges
    extended = np.concatenate([power[1:][::-1], power, power[-2:][::-1]])
    offset = bins - 1
    integral = np.concatenate([[0.], np.cumsum(extended)]) * bin_hz
    centers = np.arange(bins) * bin_hz
    half = width_hz / 2.
    positions_hi = (centers + half) / bin_hz + offset
    positions_lo = (centers - half) / bin_hz + offset
    grid = np.arange(len(integral))
    hi = np.interp(positions_hi + 1., grid, integral)
    lo = np.interp(positions_lo + 1., grid, integral)
    return np.maximum((hi - lo) / width_hz, 1e-20)


def _cheaptrick_frame(audio, fs, time, f0, fft_size):
    half = int(round(1.5 * fs / f0))
    length = 2 * half + 1
    segment = _windowed_segment(audio, fs, time, length)
    t = np.arange(-half, half + 1) / fs * f0 / 3.
    window = 0.5 + 0.5 * np.cos(2 * np.pi * t)
    # Remove the windowed mean (WORLD's waveform normalization)
    weight = window.sum()
    if weight > 0:
        segment = (segment - (segment * window).sum() / weight)
    windowed = segment * window
    # Normalize window power
    windowed /= np.sqrt((window ** 2).sum())

    power = np.abs(np.fft.rfft(windowed, fft_size)) ** 2 + 1e-20
    smoothed = _linear_smoothing(power, 2. * f0 / 3., fs, fft_size)

    # Cepstral liftering: sinc smoothing + q1 compensation
    log_power = np.log(smoothed)
    cepstrum = np.fft.irfft(log_power, fft_size)
    quefrency = np.arange(1, fft_size // 2 + 1) / fs
    smoothing = np.ones(fft_size)
    compensation = np.ones(fft_size)
    argument = np.pi * f0 * quefrency
    smoothing[1:fft_size // 2 + 1] = np.sin(argument) / argument
    smoothing[fft_size // 2 + 1:] = smoothing[1:fft_size // 2][::-1]
    compensation[1:fft_size // 2 + 1] = (
        (1. - 2. * Q1) + 2. * Q1 * np.cos(2 * np.pi * f0 * quefrency))
    compensation[fft_size // 2 + 1:] = compensation[1:fft_size // 2][::-1]
    log_envelope = np.fft.rfft(
        cepstrum * smoothing * compensation, fft_size).real
    return np.exp(log_envelope[:fft_size // 2 + 1])


def _cheaptrick(audio, fs, frame_times, f0, fft_size):
    """Spectral envelope estimation (pyworld.cheaptrick semantics)

    Returns a POWER spectral envelope, shape (fft_size // 2 + 1, frames).
    """
    f0_low_limit = 3. * fs / (fft_size - 3.)
    envelope = np.empty((fft_size // 2 + 1, len(frame_times)))
    for i, time in enumerate(frame_times):
        frame_f0 = f0[i] if f0[i] > f0_low_limit else DEFAULT_F0
        envelope[:, i] = _cheaptrick_frame(
            audio, fs, time, frame_f0, fft_size)
    return envelope


###############################################################################
# D4C (coarse band aperiodicity)
###############################################################################


def _d4c_frame(audio, fs, time, f0, fft_size, coarse_frequencies):
    """Aperiodicity per coarse band: inter-harmonic vs total power.

    Simplification of D4C's group-delay statistic: within each band,
    bins within f0/4 of a harmonic sample periodic+noise power; the
    remaining bins sample the noise floor. The amplitude aperiodicity
    is sqrt(noise power fraction).
    """
    half = int(round(2. * fs / f0))
    length = 2 * half + 1
    segment = _windowed_segment(audio, fs, time, length)
    t = np.arange(length) / max(length - 1, 1)
    window = (
        0.42 - 0.5 * np.cos(2 * np.pi * t) + 0.08 * np.cos(4 * np.pi * t))
    power = np.abs(np.fft.rfft(segment * window, fft_size)) ** 2 + 1e-20

    bin_hz = fs / fft_size
    frequencies = np.arange(len(power)) * bin_hz
    distance = np.abs(
        frequencies - np.round(frequencies / f0) * f0)
    harmonic = distance <= f0 / 4.

    coarse = np.empty(len(coarse_frequencies))
    for k, center in enumerate(coarse_frequencies):
        band = (frequencies >= center - FREQUENCY_INTERVAL / 2.) & (
            frequencies < center + FREQUENCY_INTERVAL / 2.)
        harmonic_power = power[band & harmonic].mean() if (
            band & harmonic).any() else 1e-20
        noise_power = power[band & ~harmonic].mean() if (
            band & ~harmonic).any() else harmonic_power
        fraction = noise_power / (harmonic_power + 1e-20)
        coarse[k] = np.sqrt(np.clip(fraction, 1e-6, 1.))
    return coarse


def _d4c(audio, fs, frame_times, f0, fft_size):
    """Band aperiodicity (pyworld.d4c parameterization)

    Returns an amplitude aperiodicity spectrum in (0, 1), shape
    (fft_size // 2 + 1, frames): coarse values every 3 kHz interpolated
    in dB across frequency, 0.999 for unvoiced frames.
    """
    nyquist = fs / 2.
    num_coarse = max(
        int(min(nyquist - FREQUENCY_INTERVAL, 15000.) //
            FREQUENCY_INTERVAL), 1)
    coarse_frequencies = FREQUENCY_INTERVAL * np.arange(1, num_coarse + 1)

    bins = fft_size // 2 + 1
    frequencies = np.arange(bins) * fs / fft_size
    aperiodicity = np.empty((bins, len(frame_times)))
    # Anchors: -60 dB at DC (WORLD's floor), coarse bands, last value
    # held to Nyquist
    anchor_frequencies = np.concatenate(
        [[0.], coarse_frequencies, [nyquist]])
    for i, time in enumerate(frame_times):
        if f0[i] <= 0:
            aperiodicity[:, i] = 0.999
            continue
        coarse = _d4c_frame(
            audio, fs, time, f0[i], fft_size, coarse_frequencies)
        anchors_db = 20 * np.log10(
            np.concatenate([[0.001], coarse, [coarse[-1]]]))
        values_db = np.interp(frequencies, anchor_frequencies, anchors_db)
        aperiodicity[:, i] = np.clip(
            10 ** (values_db / 20.), 0.001, 0.999)
    return aperiodicity


###############################################################################
# Analysis
###############################################################################


def analyze(audio, sample_rate=None, config=None):
    """Analyze audio → (f0, power spectral envelope, aperiodicity)

    dio and stonemask pitch, cheaptrick envelope and d4c aperiodicity,
    at HOPSIZE samples per frame; sample_rate None is SAMPLE_RATE.
    """
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    audio = np.asarray(audio, np.float64)
    if audio.ndim == 2:
        audio = audio[0]

    frames = len(audio) // config.HOPSIZE
    frame_times = np.arange(frames) * (
        config.HOPSIZE / sample_rate)

    f0, _ = _dio(
        audio, sample_rate, frame_times,
        config.FMIN, config.FMAX, ALLOWED_RANGE)
    f0 = _stonemask(
        audio, sample_rate, frame_times, f0,
        config.FMIN, config.FMAX)

    fft_size = config.NUM_FFT
    envelope = _cheaptrick(audio, sample_rate, frame_times, f0, fft_size)
    aperiodicity = _d4c(audio, sample_rate, frame_times, f0, fft_size)
    return f0, envelope, aperiodicity


###############################################################################
# Synthesis
###############################################################################


def synthesize(f0, envelope, aperiodicity, sample_rate=None, config=None):
    """WORLD-style synthesis from (f0, power envelope, aperiodicity)

    Impulse-train and white-noise excitation mixed per frequency bin by
    the aperiodicity spectrum, filtered by the spectral envelope with
    windowed overlap-add, at HOPSIZE samples per frame. Returns (1,
    frames * HOPSIZE) float32.
    """
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    hopsize = config.HOPSIZE
    num_frames = len(f0)
    num_samples = num_frames * hopsize

    # Per-sample F0 (hold per frame); impulse positions by integrating
    # phase, energy-normalized so the pulse train has unit power
    f0_samples = np.repeat(np.maximum(f0, 0.), hopsize)[:num_samples]
    voiced = f0_samples > 0
    phase = np.cumsum(np.where(voiced, f0_samples, 0.) / sample_rate)
    pulse_mask = (np.diff(np.floor(phase), prepend=0.) > 0) & voiced
    periodic = np.zeros(num_samples)
    amplitude = np.sqrt(sample_rate / np.maximum(f0_samples, 1.))
    periodic[pulse_mask] = amplitude[pulse_mask]
    noise = np.random.default_rng(0).standard_normal(num_samples)

    n_fft = envelope.shape[0] * 2 - 2
    window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    periodic = np.pad(periodic, (pad, pad))
    noise = np.pad(noise, (pad, pad))
    output = np.zeros(num_samples + 2 * pad)
    norm = np.zeros(num_samples + 2 * pad)
    gain = np.sqrt(np.maximum(envelope, 1e-20))
    for frame in range(num_frames):
        start = frame * hopsize
        spectrum_p = np.fft.rfft(periodic[start:start + n_fft] * window)
        spectrum_n = np.fft.rfft(noise[start:start + n_fft] * window)
        ap = aperiodicity[:, frame]
        mixed = gain[:, frame] * (
            spectrum_p * np.sqrt(np.maximum(1. - ap ** 2, 0.))
            + spectrum_n * ap)
        output[start:start + n_fft] += np.fft.irfft(mixed, n_fft) * window
        norm[start:start + n_fft] += window ** 2
    output = output / np.maximum(norm, 1e-8)
    output = output[pad:pad + num_samples]

    peak = np.abs(output).max()
    if peak > 1.:
        output = output / peak * 0.999
    return output.astype(np.float32)[None]


###############################################################################
# Editing
###############################################################################


def from_audio(
    audio,
    sample_rate=None,
    grid=None,
    pitch=None,
    periodicity=None,
    loudness=None,
    config=None
):
    """WORLD analysis, editing and synthesis of audio (1, T) or (T,)

    Arguments
        grid: time-stretch grid, (frames out,) positions in input frames
        pitch: F0 in Hz replacing WORLD's, per output frame; unvoiced
            frames (periodicity under VOICING_THRESHOLD where it is
            given, else WORLD's own) stay at zero
        loudness: (..., frames) A-weighted loudness in dB to match
            afterwards (`preprocess.loudness.scale`)

    Returns
        (1, frames out * HOPSIZE) float32 numpy audio
    """
    config = config_module.default() if config is None else config
    f0, envelope, aperiodicity = analyze(audio, sample_rate, config)

    # Maybe time-stretch
    if grid is not None:
        f0, envelope, aperiodicity = linear_time_stretch(
            f0, envelope, aperiodicity, np.asarray(grid))

    # Maybe pitch-shift (swap F0)
    if pitch is not None:
        pitch = np.asarray(pitch, np.float64).reshape(-1)[:f0.shape[-1]]
        new_f0 = np.zeros_like(f0)
        length = min(len(pitch), len(f0))
        if periodicity is not None:
            voiced = np.asarray(periodicity).reshape(-1)[:length] \
                >= config.VOICING_THRESHOLD
        else:
            voiced = f0[:length] > 0
        new_f0[:length] = np.where(voiced, pitch[:length], 0.)
        f0 = new_f0

    generated = synthesize(f0, envelope, aperiodicity, sample_rate, config)

    # Maybe match loudness
    if loudness is not None:
        import torch

        from ..preprocess import loudness as loudness_module
        generated = loudness_module.scale(
            torch.from_numpy(generated),
            torch.as_tensor(np.asarray(loudness, np.float32)),
            config).numpy()
    return generated


def linear_time_stretch(f0, envelope, aperiodicity, grid):
    """Time-stretch WORLD parameters along a grid, F0 in log space"""
    grid = np.asarray(grid, np.float64).reshape(-1)
    voiced = f0 > 0
    frames = np.arange(f0.shape[-1])

    if voiced.any():
        # Linearly interpolate F0 through unvoiced regions, stretch in
        # log2 space, reapply the stretched voicing mask
        filled = f0.copy()
        filled[~voiced] = np.interp(
            frames[~voiced], frames[voiced], f0[voiced])
        stretched_log = np.interp(grid, frames, np.log2(filled))
        stretched_voiced = np.interp(
            grid, frames, voiced.astype(np.float64)) > .5
        stretched_f0 = np.where(stretched_voiced, 2. ** stretched_log, 0.)
    else:
        stretched_f0 = np.zeros(len(grid))

    def stretch_rows(matrix):
        return np.stack([np.interp(grid, frames, row) for row in matrix])

    return (
        stretched_f0,
        stretch_rows(envelope),
        stretch_rows(aperiodicity))
