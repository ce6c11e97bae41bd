"""Formant speech, the benchmark's traffic source

A frozen copy of `promonet_tpu_torch/data/synthetic.py` at commit
ce32675 (its speaker profiles, phone sequences and Klatt-style
source-filter synthesizer), kept here so that the benchmark's inputs do
not move when the program's copy does. Changes from that file: the
configuration is `SETTINGS` (sample rate, hop, pitch range of the
default configuration) in place of a `config.Config`, the phoneme table
is written out, and the corpus writer (`create`) and the harmonic-stack
utterance are left out. numpy and scipy only.
"""

import numpy as np

import types

# The default configuration's values that the synthesizer reads
SETTINGS = types.SimpleNamespace(
    SAMPLE_RATE=22050, HOPSIZE=256, FMIN=50., FMAX=550.)

# 39 CMUdict phonemes + silence, in the PPG's order
PHONEMES = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'ch', 'd', 'dh',
    'eh', 'er', 'ey', 'f', 'g', 'hh', 'ih', 'iy', 'jh', 'k',
    'l', 'm', 'n', 'ng', 'ow', 'oy', 'p', 'r', 's', 'sh',
    't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', '<silence>']
PHONEME_TO_INDEX_MAPPING = {p: i for i, p in enumerate(PHONEMES)}
SILENCE = '<silence>'


###############################################################################
# Phoneme acoustic recipes
###############################################################################


# Monophthong formant targets (F1, F2, F3) in Hz — Peterson & Barney-style
# male averages; scaled per speaker by the vocal-tract factor
VOWELS = {
    'aa': (730, 1090, 2440),
    'ae': (660, 1720, 2410),
    'ah': (640, 1190, 2390),
    'ao': (570, 840, 2410),
    'eh': (530, 1840, 2480),
    'er': (490, 1350, 1690),
    'ih': (390, 1990, 2550),
    'iy': (270, 2290, 3010),
    'uh': (440, 1020, 2240),
    'uw': (300, 870, 2240),
}

# Diphthongs as (start, end) monophthong targets
DIPHTHONGS = {
    'aw': ('aa', 'uw'),
    'ay': ('aa', 'iy'),
    'ey': ('eh', 'iy'),
    'ow': ('ao', 'uw'),
    'oy': ('ao', 'iy'),
}

# Glides and liquids: vowel-like, lower amplitude, shorter
GLIDES = {
    'l': (360, 1300, 2700),
    'r': (310, 1060, 1380),   # characteristically low F3
    'w': (300, 610, 2200),
    'y': (270, 2290, 3010),
}

# Nasals: low-F1 murmur with damped higher formants
NASALS = {
    'm': (250, 1000, 2200),
    'n': (250, 1700, 2600),
    'ng': (250, 2300, 2750),
}

# Fricatives: (noise center Hz, noise bandwidth Hz, voiced)
FRICATIVES = {
    'f': (4500, 5000, False),
    'th': (5200, 5000, False),
    's': (6500, 3000, False),
    'sh': (3200, 2000, False),
    'hh': (1500, 3500, False),
    'v': (3500, 4500, True),
    'dh': (4200, 5000, True),
    'z': (6500, 3000, True),
    'zh': (3200, 2000, True),
}

# Plosives: (burst center Hz, voiced)
PLOSIVES = {
    'p': (900, False),
    't': (4200, False),
    'k': (2200, False),
    'b': (800, True),
    'd': (3800, True),
    'g': (1900, True),
}

# Affricates as stop + fricative
AFFRICATES = {
    'ch': ('t', 'sh'),
    'jh': ('d', 'zh'),
}

CONSONANTS = (
    list(GLIDES) + list(NASALS) + list(FRICATIVES) + list(PLOSIVES) +
    list(AFFRICATES))


###############################################################################
# Speaker profiles
###############################################################################


def sample_speaker(rng, index=0):
    """Sample a speaker profile: vocal-tract scale, F0 range, voice quality"""
    return {
        'index': index,
        # Vocal-tract length factor scales all formant targets
        'alpha': float(rng.uniform(0.85, 1.2)),
        # Base F0 bimodal across typical ranges
        'f0_base': float(
            rng.uniform(95., 150.) if rng.random() < 0.5
            else rng.uniform(160., 240.)),
        'f0_range': float(rng.uniform(0.15, 0.4)),     # octaves of movement
        'breathiness': float(rng.uniform(0.02, 0.12)),
        'jitter': float(rng.uniform(0.003, 0.012)),
        'shimmer': float(rng.uniform(0.02, 0.08)),
        'rate': float(rng.uniform(0.85, 1.2)),
    }


###############################################################################
# Phone sequence sampling
###############################################################################


def sample_phones(rng, seconds, rate=1.0):
    """Random syllable sequence [(phone, duration_seconds), ...]

    CV(C) syllables with occasional pauses; leading/trailing silence.
    Durations are speech-typical, scaled by the speaking rate.
    """
    def dur(lo, hi):
        return float(rng.uniform(lo, hi) / rate)

    phones = [(SILENCE, dur(0.05, 0.12))]
    total = phones[0][1]
    vowels = list(VOWELS) + list(DIPHTHONGS)
    while total < seconds - 0.15:
        # Onset consonant (usually)
        if rng.random() < 0.85:
            onset = CONSONANTS[rng.integers(len(CONSONANTS))]
            d = dur(0.05, 0.13)
            phones.append((onset, d))
            total += d
        # Nucleus
        vowel = vowels[rng.integers(len(vowels))]
        d = dur(0.09, 0.22)
        phones.append((vowel, d))
        total += d
        # Coda (sometimes)
        if rng.random() < 0.35:
            coda = CONSONANTS[rng.integers(len(CONSONANTS))]
            d = dur(0.04, 0.11)
            phones.append((coda, d))
            total += d
        # Pause between "words"
        if rng.random() < 0.18:
            d = dur(0.06, 0.18)
            phones.append((SILENCE, d))
            total += d
    phones.append((SILENCE, dur(0.05, 0.12)))
    return phones


###############################################################################
# Formant synthesis
###############################################################################


def _resonator(frequency, bandwidth, sample_rate):
    """Two-pole resonator coefficients normalized to unit gain at resonance"""
    r = np.exp(-np.pi * bandwidth / sample_rate)
    w0 = 2 * np.pi * frequency / sample_rate
    a = np.array([1., -2. * r * np.cos(w0), r * r])
    # Normalize |H| at the resonant frequency
    z = np.exp(-1j * w0)
    gain = abs(a[0] + a[1] * z + a[2] * z * z)
    return np.array([gain, 0., 0.]), a


def _smooth(track, sample_rate, ms):
    """Moving-average smoothing (coarticulation)"""
    width = max(1, int(sample_rate * ms / 1000.))
    kernel = np.ones(width) / width
    return np.convolve(track, kernel, mode='same')


def synthesize(rng, phones, profile, sample_rate=None, config=None):
    """Formant-synthesize a phone sequence.

    Arguments
        rng: numpy Generator
        phones: [(phone, seconds), ...]
        profile: speaker profile from sample_speaker
        sample_rate: output rate; None is config.SAMPLE_RATE
        config: the settings; None is `SETTINGS`

    Returns
        audio: (1, T) float32
        labels: (frames,) int32 phoneme indices at frame centers
        f0: (frames,) float32 ground-truth F0 in Hz (defined everywhere)
        voiced: (frames,) bool voicing at frame centers
    """
    import scipy.signal

    config = SETTINGS if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    hopsize = int(config.HOPSIZE * sample_rate / config.SAMPLE_RATE)
    alpha = profile['alpha']

    # Segment boundaries in samples; expand affricates and plosives into
    # acoustic sub-segments that keep the parent phoneme's label
    segments = []  # (label, voice, f1..f3, noise_amp, noise_cf, noise_bw,
    #                burst, samples)
    for phone, seconds in phones:
        num = max(1, int(round(seconds * sample_rate)))
        segments.extend(_phone_segments(phone, num, alpha, sample_rate))
    total = sum(seg['samples'] for seg in segments)

    # Per-sample parameter tracks
    tracks = {
        key: np.zeros(total)
        for key in (
            'voice', 'f1', 'f2', 'f3', 'b1', 'b2', 'b3',
            'noise', 'noise_cf', 'noise_bw', 'burst')}
    labels_samples = np.zeros(total, dtype=np.int32)
    cursor = 0
    for seg in segments:
        sl = slice(cursor, cursor + seg['samples'])
        labels_samples[sl] = PHONEME_TO_INDEX_MAPPING[seg['label']]
        n = seg['samples']
        ramp = np.linspace(0., 1., n)
        for key in ('voice', 'f1', 'f2', 'f3', 'b1', 'b2', 'b3',
                    'noise', 'noise_cf', 'noise_bw', 'burst'):
            value = seg[key]
            if isinstance(value, tuple):  # (start, end) trajectory
                tracks[key][sl] = value[0] + (value[1] - value[0]) * ramp
            else:
                tracks[key][sl] = value
        cursor += n

    # Coarticulation: smooth formants more than amplitudes; keep bursts sharp
    for key in ('f1', 'f2', 'f3', 'b1', 'b2', 'b3', 'noise_cf', 'noise_bw'):
        tracks[key] = _smooth(tracks[key], sample_rate, 22.)
    for key in ('voice', 'noise'):
        tracks[key] = _smooth(tracks[key], sample_rate, 8.)

    # F0 contour: declination + phrase accents + jitter
    t = np.arange(total) / sample_rate
    duration = total / sample_rate
    declination = 2. ** (
        profile['f0_range'] * (0.35 - 0.55 * t / max(duration, 1e-6)))
    accents = 2. ** (
        profile['f0_range'] * 0.4 *
        np.sin(2 * np.pi * rng.uniform(0.8, 2.0) * t + rng.uniform(0, np.pi)))
    jitter = np.exp(
        _smooth(rng.standard_normal(total), sample_rate, 12.)
        * profile['jitter'] * 12.)
    f0 = np.clip(
        profile['f0_base'] * declination * accents * jitter,
        1.05 * config.FMIN,
        0.95 * config.FMAX)

    # Glottal source: impulse train with shimmer → 2×leaky integration
    # (-12 dB/oct glottal spectrum) → DC removal
    phase = np.cumsum(f0) / sample_rate
    pulses = np.diff(np.floor(phase), prepend=0.) > 0
    amplitudes = np.ones(total)
    amplitudes[pulses] = 1. + profile['shimmer'] * rng.standard_normal(
        int(pulses.sum()))
    source = np.where(pulses, amplitudes, 0.)
    source = scipy.signal.lfilter([1.], [1., -0.96], source)
    source = scipy.signal.lfilter([1.], [1., -0.9], source)
    source = scipy.signal.lfilter([1., -1.], [1., -0.995], source)  # de-DC
    # Aspiration noise (breathiness) mixes into the voiced source
    aspiration = profile['breathiness'] * rng.standard_normal(total)
    voiced_source = tracks['voice'] * (source + aspiration)

    # Time-varying cascade formant filter, block-updated per hop
    out = np.zeros(total)
    zi = [np.zeros(2), np.zeros(2), np.zeros(2)]
    for start in range(0, total, hopsize):
        sl = slice(start, min(start + hopsize, total))
        center = min(start + hopsize // 2, total - 1)
        x = voiced_source[sl]
        for k, (fk, bk) in enumerate(
                (('f1', 'b1'), ('f2', 'b2'), ('f3', 'b3'))):
            b, a = _resonator(
                max(tracks[fk][center], 90.),
                max(tracks[bk][center], 40.),
                sample_rate)
            x, zi[k] = scipy.signal.lfilter(b, a, x, zi=zi[k])
        out[sl] = x

    # Frication/burst noise path (generated at the constriction,
    # bypasses the formant cascade), block-filtered bandpass
    noise_amp = tracks['noise'] + tracks['burst']
    if noise_amp.max() > 0:
        noise = rng.standard_normal(total)
        shaped = np.zeros(total)
        zn = np.zeros(2)
        for start in range(0, total, hopsize):
            sl = slice(start, min(start + hopsize, total))
            center = min(start + hopsize // 2, total - 1)
            cf = np.clip(tracks['noise_cf'][center], 200., 0.45 * sample_rate)
            bw = np.clip(tracks['noise_bw'][center], 200., 0.5 * sample_rate)
            b, a = _resonator(cf, bw, sample_rate)
            shaped[sl], zn = scipy.signal.lfilter(b, a, noise[sl], zi=zn)
        out = out + noise_amp * shaped

    # Normalize to a randomized utterance peak
    peak = np.abs(out).max()
    if peak > 0:
        out = out * (rng.uniform(0.35, 0.55) / peak)

    # Frame-rate ground truth at frame centers (i + 0.5) * hop — matching
    # the pitch estimator's center='half-hop' placement
    frames = total // hopsize
    centers = np.minimum(
        ((np.arange(frames) + 0.5) * hopsize).astype(np.int64), total - 1)
    labels = labels_samples[centers]
    frame_f0 = f0[centers].astype(np.float32)
    frame_voiced = tracks['voice'][centers] > 0.25

    return (
        out[:frames * hopsize].astype(np.float32)[None],
        labels.astype(np.int32),
        frame_f0,
        frame_voiced)


def _phone_segments(phone, num, alpha, sample_rate):
    """Expand a phone into acoustic sub-segments (all keep the label)"""
    neutral = VOWELS['ah']

    def seg(samples, voice=0., formants=neutral, bandwidths=(90, 110, 170),
            noise=0., noise_cf=3000., noise_bw=3000., burst=0.):
        f = [float(x) * alpha for x in (
            formants if not isinstance(formants[0], tuple) else formants[0])]
        if isinstance(formants[0], tuple):  # ((f1a,f1b),(f2a,f2b),(f3a,f3b))
            return {
                'label': phone, 'samples': samples, 'voice': voice,
                'f1': (formants[0][0] * alpha, formants[0][1] * alpha),
                'f2': (formants[1][0] * alpha, formants[1][1] * alpha),
                'f3': (formants[2][0] * alpha, formants[2][1] * alpha),
                'b1': float(bandwidths[0]), 'b2': float(bandwidths[1]),
                'b3': float(bandwidths[2]),
                'noise': noise, 'noise_cf': noise_cf * alpha,
                'noise_bw': noise_bw, 'burst': burst}
        return {
            'label': phone, 'samples': samples, 'voice': voice,
            'f1': f[0], 'f2': f[1], 'f3': f[2],
            'b1': float(bandwidths[0]), 'b2': float(bandwidths[1]),
            'b3': float(bandwidths[2]),
            'noise': noise, 'noise_cf': noise_cf * alpha,
            'noise_bw': noise_bw, 'burst': burst}

    if phone == SILENCE:
        return [seg(num)]
    if phone in VOWELS:
        return [seg(num, voice=1., formants=VOWELS[phone])]
    if phone in DIPHTHONGS:
        a, b = DIPHTHONGS[phone]
        fa, fb = VOWELS[a], VOWELS[b]
        return [seg(
            num, voice=1.,
            formants=tuple(zip(fa, fb)))]
    if phone in GLIDES:
        return [seg(
            num, voice=0.7, formants=GLIDES[phone],
            bandwidths=(120, 140, 200))]
    if phone in NASALS:
        return [seg(
            num, voice=0.5, formants=NASALS[phone],
            bandwidths=(120, 300, 400))]
    if phone in FRICATIVES:
        cf, bw, voiced = FRICATIVES[phone]
        return [seg(
            num,
            voice=0.35 if voiced else 0.,
            formants=(300, 1400, 2400) if voiced else neutral,
            noise=0.28, noise_cf=cf, noise_bw=bw)]
    if phone in PLOSIVES:
        cf, voiced = PLOSIVES[phone]
        closure = max(1, int(0.55 * num))
        burst = max(1, int(0.2 * num))
        release = max(1, num - closure - burst)
        parts = [
            # Closure: silence, or a low voice bar for voiced stops
            seg(closure, voice=0.12 if voiced else 0.,
                formants=(180, 1000, 2400), bandwidths=(80, 400, 500)),
            # Burst: sharp noise at the place-of-articulation locus
            seg(burst, noise_cf=cf, noise_bw=2500., burst=0.4),
        ]
        # Aspiration (unvoiced) or quick voicing onset (voiced)
        if voiced:
            parts.append(seg(
                release, voice=0.6, formants=neutral,
                bandwidths=(110, 140, 210)))
        else:
            parts.append(seg(
                release, noise=0.12, noise_cf=1600., noise_bw=3500.))
        return parts
    if phone in AFFRICATES:
        stop, fric = AFFRICATES[phone]
        split = max(1, int(0.45 * num))
        head = _phone_segments(stop, split, alpha, sample_rate)
        tail = _phone_segments(fric, num - split, alpha, sample_rate)
        for part in head + tail:
            part['label'] = phone
        return head + tail
    raise ValueError(f'Unknown phone {phone}')


def generate_aligned_utterance(rng, profile=None, seconds=2.0,
                               sample_rate=None, config=None):
    """Formant-synthesize one utterance with ground-truth alignments

    Returns (audio (1, T), phones [(name, sec), ...], labels, f0, voiced)
    """
    if profile is None:
        profile = sample_speaker(rng)
    phones = sample_phones(rng, seconds, profile['rate'])
    audio, labels, f0, voiced = synthesize(
        rng, phones, profile, sample_rate, config)
    return audio, phones, labels, f0, voiced
