"""Speech harmonic contours F0..Fk

Counterpart of `promonet_tpu/preprocess/harmonics.py`. Analysis features
come from a high-passed, band-limited STFT (or LPC envelopes, or NCC
pitch posteriors); decoding is peak picking or an iterative masked
Viterbi over the whole frequency axis, whose large-state decode is
`ops.viterbi.decode_logfreq` (a CUDA kernel on the card). Filtering,
resampling and LPC run on the host in numpy and scipy, as in the JAX
package; the STFT, the NCC and the decodes run on `device`.
"""
import numpy as np
import scipy.signal
import torch

from .. import config as config_module
from .. import device as device_module
from .. import load
from ..ops import stft as stft_ops, viterbi as viterbi_ops
from ..utils import audio as audio_module
from . import pitch as pitch_module

# Gain of each analysis feature before the Viterbi decode: its
# low-frequency prior is calibrated for raw STFT magnitudes, and
# log-scale LPC envelopes and [-1, 1] correlations need gain to compete
OBSERVATION_SCALE = {'stft': 1., 'lpc': 100., 'posteriorgram': 400.}


def from_audio(
    audio,
    sample_rate=None,
    pitch=None,
    features='stft',
    decoder='viterbi',
    max_harmonics=None,
    return_features=False,
    config=None,
    device='cuda'
):
    """Compute speech harmonic contours of audio (1, T)

    Arguments
        audio: (1, T) numpy waveform
        sample_rate: rate of `audio`; None is config.SAMPLE_RATE
        pitch: (1, frames) F0 in Hz to use as the first contour; None
            decodes it
        features: 'stft', 'lpc' or 'posteriorgram'
        decoder: 'viterbi' or 'peak'
        max_harmonics: number of contours; None is config.MAX_HARMONICS
        return_features: also return the analysis features (N, frames)
        device: where to run; 'cuda' raises on a host without a card

    Returns
        harmonics: (max_harmonics, frames) float32 tensor on `device`, in
        Hz; NaN where fewer harmonics exist
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    if max_harmonics is None:
        max_harmonics = config.MAX_HARMONICS
    audio = np.asarray(audio)

    with torch.no_grad():
        if features == 'stft':
            frames, frequencies = stft_features(
                audio, sample_rate, config=config, device=device)
        elif features == 'lpc':
            frames, frequencies = lpc_coefficients(
                audio, sample_rate, config=config, device=device)
        elif features == 'posteriorgram':
            frames, frequencies = pitch_posteriorgram(
                audio, sample_rate, config=config, device=device)
        else:
            raise ValueError(
                f'Harmonic analysis features {features} are not defined')

        if decoder == 'peak':
            harmonics = peak_pick(frames, frequencies, max_harmonics)
        elif decoder == 'viterbi':
            harmonics = viterbi(
                frames * OBSERVATION_SCALE[features],
                frequencies,
                pitch,
                max_harmonics)
        else:
            raise ValueError(f'Harmonic decoder {decoder} is not defined')

    if return_features:
        return harmonics, frames.T
    return harmonics


def from_file(file, pitch_file=None, config=None, device='cuda', **kwargs):
    """Harmonic contours of a wav file; see `from_audio`

    pitch_file: a saved F0 contour to use as the first contour
    """
    config = config_module.default() if config is None else config
    pitch = None if pitch_file is None else load.array(pitch_file)
    return from_audio(
        load.audio(file, config), pitch=pitch, config=config, device=device,
        **kwargs)


def from_file_to_file(file, output_file, pitch_file=None, config=None,
                      device='cuda', **kwargs):
    """Harmonic contours of a wav file, saved to `output_file`"""
    load.save_array(
        output_file, from_file(file, pitch_file, config, device, **kwargs))


def from_files_to_files(files, output_files, pitch_files=None, config=None,
                        device='cuda', **kwargs):
    """Harmonic contours of several wav files, in turn"""
    if pitch_files is None:
        pitch_files = [None] * len(files)
    for file, output_file, pitch_file in zip(files, output_files, pitch_files):
        from_file_to_file(
            file, output_file, pitch_file, config, device, **kwargs)


###############################################################################
# Decode
###############################################################################


def peak_pick(frames, frequencies, max_harmonics):
    """The lowest `max_harmonics` spectral peaks of each frame, on the host"""
    spectra = frames.cpu().numpy()
    harmonics = np.full((max_harmonics, len(spectra)), np.nan, np.float32)
    for i, frame in enumerate(spectra):
        peaks = scipy.signal.find_peaks(frame)[0]
        for j, peak in enumerate(sorted(peaks)[:max_harmonics]):
            harmonics[j, i] = frequencies[peak]
    return torch.from_numpy(harmonics).to(frames.device)


def viterbi(
    frames,
    frequencies,
    pitch=None,
    max_harmonics=3,
    harmonic_width_ratio=0.8
):
    """Iterative masked Viterbi decoding of F0..Fk

    The fundamental is decoded over the whole axis under a low-frequency
    bias (or given as `pitch`); harmonic i is then decoded over the band
    F0 * (i + ratio) .. F0 * (i + 1 / ratio) of each frame, everything
    else masked to -inf. The bands depend on F0 alone, so the harmonics
    above it are decoded as one batch (one kernel launch on the card). A
    frame whose band is empty has an all-NaN log-softmax; the decode then
    takes NaN as the maximum, as the JAX package's does.

    Arguments
        frames: (T, N) float32 tensor of analysis features
        frequencies: (N,) ascending float32 numpy axis in Hz
        pitch: (1, T) or (T,) F0 in Hz, or None

    Returns
        (max_harmonics, T) float32 tensor on the device of `frames`
    """
    device = frames.device
    num_frames, num_states = frames.shape
    frequencies = np.asarray(frequencies, np.float32)
    axis = torch.from_numpy(frequencies).to(device)

    # Initial distribution: linearly decreasing with frequency
    initial = torch.linspace(1., 0., num_states, device=device)
    initial = initial / initial.sum()
    log_initial = torch.log(torch.clamp(initial, min=1e-12))

    def decode(observation):
        """Contours in Hz of one (T, N) observation or a (B, T, N) batch"""
        return axis[viterbi_ops.decode_logfreq(
            torch.log_softmax(observation, dim=-1), frequencies,
            log_initial).long()]

    def mask(i, f0):
        """The frames outside harmonic i's band around `f0` set to -inf"""
        low = torch.searchsorted(
            axis, (f0 * (i + harmonic_width_ratio)).contiguous())
        high = torch.searchsorted(
            axis, (f0 * (i + 1. / harmonic_width_ratio)).contiguous())
        columns = torch.arange(num_states, device=device)[None, :]
        in_band = (columns >= low[:, None]) & (columns < high[:, None])
        return torch.where(in_band, frames, -float('inf'))

    harmonics = torch.full(
        (max_harmonics, num_frames), float('nan'), device=device)
    if max_harmonics < 1:
        return harmonics

    if pitch is not None:
        harmonics[0] = torch.as_tensor(
            pitch, dtype=torch.float32).to(device).reshape(-1)
    else:
        # Low-frequency bias
        harmonics[0] = decode(frames + .5 * torch.arange(
            num_states, 0, -1, device=device))

    # Every further harmonic's band depends on F0 alone: one batch
    if max_harmonics > 1:
        harmonics[1:] = decode(torch.stack([
            mask(i, harmonics[0]) for i in range(1, max_harmonics)]))

    return harmonics


###############################################################################
# Analysis features
###############################################################################


def _levinson_durbin(autocorrelation, order):
    """Levinson-Durbin recursion: autocorrelation → LPC coefficients"""
    a = np.zeros(order + 1)
    a[0] = 1.
    error = autocorrelation[0]
    if error <= 0:
        return a
    for i in range(1, order + 1):
        acc = autocorrelation[i] + np.dot(
            a[1:i], autocorrelation[i - 1:0:-1])
        k = -acc / error
        a[1:i + 1] = a[1:i + 1] + k * a[i - 1::-1][:i]
        error *= (1. - k * k)
        if error <= 0:
            break
    return a


def lpc_coefficients(audio, sample_rate=None, config=None, device='cuda'):
    """LPC spectral envelopes: (frames, N) tensor and (N,) frequencies

    Hamming-windowed frames → LPC of order sample_rate / 1000 + 2 (the
    autocorrelation method, on the host) → log-magnitude of the all-pole
    response at the analysis frequencies, cropped below FMIN. The result
    is placed on `device`; 'cuda' raises on a host without a card.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    audio = np.asarray(audio)

    padding = (config.WINDOW_SIZE - config.HOPSIZE) // 2
    padded = np.pad(
        audio, [(0, 0)] * (audio.ndim - 1) + [(padding, padding)])
    samples = padded[0] if padded.ndim == 2 else padded
    num_frames = 1 + (
        (samples.shape[-1] - config.WINDOW_SIZE) // config.HOPSIZE)
    window = np.hamming(config.WINDOW_SIZE)
    order = int(sample_rate / 1000) + 2

    frequencies = sample_rate * np.linspace(0., 1., config.NUM_FFT)
    frequencies = frequencies[:len(frequencies) // 2]

    result = np.empty((num_frames, len(frequencies)), np.float32)
    for i in range(num_frames):
        start = i * config.HOPSIZE
        frame = samples[start:start + config.WINDOW_SIZE] * window
        spectrum = np.fft.rfft(frame, 2 * config.WINDOW_SIZE)
        autocorrelation = np.fft.irfft(np.abs(spectrum) ** 2)[:order + 1]
        a = _levinson_durbin(autocorrelation, order)
        _, h = scipy.signal.freqz([1], a, worN=len(frequencies))
        result[i] = np.log10(np.abs(h) + 1e-12)

    # Crop below FMIN so the pole at DC cannot absorb the decode
    minidx = int(np.searchsorted(frequencies, config.FMIN))
    return (
        torch.from_numpy(result[:, minidx:]).to(device),
        frequencies[minidx:].astype(np.float32))


def pitch_posteriorgram(
    audio, sample_rate=None, fmin=50., fmax=1600., config=None, device='cuda'
):
    """NCC over 512 candidates in [fmin, fmax]: (frames, 512), frequencies

    Runs on `device`; 'cuda' raises on a host without a card.
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    frequencies = pitch_module.candidate_frequencies(fmin, fmax, 512)
    samples = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    return (
        pitch_module.ncc(samples, sample_rate, config.HOPSIZE, frequencies),
        frequencies)


def highpass_biquad(audio, sample_rate, cutoff, q=0.707):
    """RBJ high-pass biquad on the host (scipy `lfilter`), float32"""
    w0 = 2 * np.pi * cutoff / sample_rate
    alpha = np.sin(w0) / (2 * q)
    cosw = np.cos(w0)
    b = np.array([(1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return scipy.signal.lfilter(b / a[0], a / a[0], audio, axis=-1).astype(
        np.float32)


def stft_features(
    audio, sample_rate=None, fmin=None, fmax=None, config=None, device='cuda'
):
    """High-passed, band-limited STFT magnitudes for harmonic analysis

    The audio is high-passed at 1.33 * fmin and resampled to 2 * fmax on
    the host, reflect-padded so that frame i is centered as the other
    features' frame i, and analysed with a 4096-point Hann window on
    `device`; 'cuda' raises on a host without a card.

    Returns
        frames: (frames, N) float32 magnitudes of the bins from fmin up
        frequencies: (N,) float32 numpy axis in Hz
    """
    device = device_module.resolve(device)
    config = config_module.default() if config is None else config
    if sample_rate is None:
        sample_rate = config.SAMPLE_RATE
    if fmin is None:
        fmin = config.FMIN
    if fmax is None:
        fmax = sample_rate // 2

    audio = np.asarray(audio)
    num_frames = audio.shape[-1] // config.HOPSIZE

    audio = highpass_biquad(audio, sample_rate, 1.33 * fmin)
    target_sample_rate = 2 * fmax
    audio = audio_module.resample(audio, sample_rate, target_sample_rate)

    num_fft = 4096
    hopsize = int(config.HOPSIZE * target_sample_rate / sample_rate)
    size = (
        hopsize * (num_frames - (audio.shape[-1] // hopsize)) // 2 +
        (num_fft - config.HOPSIZE) // 2)
    audio = np.pad(
        audio, [(0, 0)] * (audio.ndim - 1) + [(size, size)], mode='reflect')

    spectrogram = stft_ops.stft(
        torch.from_numpy(audio[0]).to(device),
        num_fft,
        hopsize,
        window=stft_ops.hann_window(num_fft, device=device),
        magnitude=True,
        magnitude_epsilon=1e-6)

    frequencies = np.abs(
        np.fft.fftfreq(num_fft, 1 / target_sample_rate)[:num_fft // 2 + 1])
    minidx = int(np.searchsorted(frequencies, fmin))
    return (
        spectrogram[minidx:].transpose(-1, -2),
        frequencies[minidx:].astype(np.float32))
