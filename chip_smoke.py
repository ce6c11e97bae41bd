#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (promonet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero:

1. device: the card's name and power limit.
2. build: the three CUDA kernels from `promonet_tpu_torch/csrc`, one
   `nvcc` each, in parallel.
3. check: each kernel against its plain PyTorch version on the card.
   The residual block (K1) at every (C, k) of the main path, at the
   main path's shapes (batch 1), at ragged lengths (batch 4), at the
   batched path's (batch 8 on the 896-frame bucket) and at the streaming
   window's (batch 1, 64 frames), bounded per element by
   |kernel - plain| <= 2^-5 * (|plain| + 2 * rms(plain)), and at every
   batch above one the bound must fail once a single bias is zeroed; the
   same at an
   odd width (C = 48, k = 7, batch 2), which the wrapper zero-pads, and
   at lengths shorter than one thread block of the fused pair, ending
   inside its recomputed halo, and shorter than the halo. The
   Viterbi decode (K2) on random, tie-heavy, -inf-masked and NaN-frame
   (896, 256) observations, on one, two and 4096 frames, under an
   all-equal and a random dense transition (no band) and on a batch of
   three, paths equal exactly to the plain scan's on the card and on the
   CPU. The log-frequency Viterbi decode (K3) on random, tie-heavy,
   -inf-masked, NaN-frame and empty-band (861, 2039) observations over
   the harmonics path's frequency axis, on a batch of two against two
   single decodes, on (70, 200) (a cluster of one block), on one and two
   frames, on the same axis through the grid route, and on a 3000-state
   axis that takes the grid route by the rule, paths equal exactly; the
   harmonics axis must take the cluster route.
4. main path, full width (HiFi-GAN 512, 109 speakers), weights seeded
   from numpy: preprocess.from_audio(loudness_bands=None) →
   edit.from_features(+400 cents, stretch 1/1.4, +3 dB) →
   synthesize.from_features(speaker=3) on 10 s of harmonic audio. The
   launch counters must show 12 residual-block calls and 1 Viterbi
   decode per utterance; the audio must be finite and frames * HOPSIZE
   long. The second call is timed.
5. reference: a half-second input on the card and through the plain
   CPU path in float32 with the same weights: loudness within 0.05 dB,
   PPG within 1e-3, and the generator's audio from the same features
   within 5% relative RMS (bf16 on the card against float32).
6. second path, full width, the same 10 s: preprocess.from_audio with
   'harmonics' (the counters must show two log-frequency launches for
   the MAX_HARMONICS decodes: F0, then the other harmonics as one batch;
   the contours must be (3, frames), finite and within three
   bins of the signal's harmonics in the median, equal to the contours
   that the plain scan over the dense transition decodes on the card
   from the same 10 s of STFT frames, and on a half-second input equal
   to the plain CPU path's on the same STFT frames), then
   synthesize.from_edited_audio with the defaults and with
   PITCH_ESTIMATOR='dsp' and stretch_unvoiced=False (12 residual-block
   calls and 1 Viterbi decode each, finite audio of
   round(frames * 1.4) * HOPSIZE samples). Second calls are timed.
7. batched path: eight utterances of one bucket (the 10 s audio extended
   to its 896-frame bucket, at eight pitch shifts and speakers) through
   synthesize.from_features_batched, one generator call with K1 at batch
   8 (12 residual-block calls); each row within the bf16 bound of its own
   single from_features call.
8. stream path: synthesize.Streamer (16 | 32 | 16 frames) fed the main
   path's 861 frames in 10-frame pieces, then flushed: 12 residual-block
   calls per window, frames * HOPSIZE finite samples, interior
   correlation with offline synthesis above 0.9.
9. FARGAN path (configs/fargan.py, bf16, seeded): synthesize.from_features
   offline, then synthesize.FARGANStreamer in 32-frame chunks; no kernel
   launches; the chunked audio held to the offline audio by the bounds
   FARGAN_FIRST_FRAMES_BOUND (first four frames), FARGAN_MAX_ABS_BOUND
   and FARGAN_CORRELATION_BOUND.
10. Vocos path (configs/baselines/vocos.py, bf16, seeded): finite audio
   of frames * HOPSIZE samples, no kernel launches.
11. file path: the 10 s audio as a wav file → preprocess.from_file_to_file
   → harmonics.from_file_to_file (with the saved pitch) →
   edit.from_file_to_file → synthesize.from_file_to_file, in a temporary
   directory under build/: the cache's file names, an output of
   round(frames * 1.4) * HOPSIZE samples, 12 residual-block calls, 1
   Viterbi decode and 1 log-frequency launch; edit.from_file's features
   must lie on the card and equal the files the chain wrote.
   Paths 7 to 11 are each timed on their second call, with every launch
   count set to 0 just before it and read just after; one call of the
   batched path, one streaming window, one FARGAN chunk and one Vocos
   call are then run under torch.profiler for their device events and
   busy time.
12. time and kernels: K1 per (T, C, k) with its time, TFLOP/s, CUDA
   launches per Block, the time at each number of row tiles per thread
   block, the plain chain's and cuDNN's times and the bound; K2 with the
   forward pass and the backtrace timed apart, microseconds per frame
   and the time at 4096 frames; K3 with its route and cluster size, the
   forward pass and the backtrace apart, microseconds per frame at 2039
   and at 200 states, a batch of two, the grid route on the same input,
   the reading behind the split's cost per destination and the cycles of
   each section of a frame. Then per
   kernel its
   launches, error (for the two decodes the largest difference in state
   index seen in this run's checks), time, plain and library times and
   the card's bound, then the card's name and power limit, then
   {"ok": true, "device": ...} as the last line.

TF32 is off for every comparison (cuDNN and cuBLAS), so float32 work
runs in float32.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

DILATIONS = (1, 3, 5)
KERNEL_SIZES = (3, 7, 11)

# Frames the batched path's utterances are padded to (10 s of audio is
# 861 frames) and frames of one window of synthesize.Streamer's default
# 16 | 32 | 16
BATCHED_BUCKET = 896
STREAM_WINDOW = 64
BF16_RTOL = 2. ** -5

# Chunked FARGAN against one offline pass, in bf16: the conditioning
# network's products run over other row counts, and a rounding that
# differs is fed back through the recurrence. Bounds: the first four
# frames within one bf16 step at the output's scale (2^-10 for samples in
# [0.125, 0.25); the seeded output peaks near 0.18), the whole 10 s
# within four, correlation as the JAX package's float32 contract. On an
# H100 the first four frames were equal, the whole within one step and
# the correlation 0.9999957.
FARGAN_FIRST_FRAMES_BOUND = 2. ** -10
FARGAN_MAX_ABS_BOUND = 2. ** -8
FARGAN_CORRELATION_BOUND = 0.9999


def within_bf16_bound(torch, kernel, plain):
    """|kernel - plain| <= 2^-5 * (|plain| + 2 * rms(plain)) everywhere

    Four bf16 ulps relative to the element, with a floor at twice the
    output's RMS: where the residual add cancels, a rounding flipped
    early in the chain leaves an error at the scale of the operands, not
    of the small sum.
    """
    floor = 2 * plain.pow(2).mean().sqrt()
    return bool(torch.all(
        (kernel - plain).abs() <= BF16_RTOL * (plain.abs() + floor)).item())


EDIT = dict(
    pitch_shift_cents=400., time_stretch_ratio=1 / 1.4, loudness_scale_db=3.)


def emit(**record):
    print(json.dumps(record), flush=True)


def harmonic_audio(seconds, sample_rate):
    """The verification signal: 4 harmonics of a vibrato around 180 Hz"""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / sample_rate
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def elapsed_ms(torch, function, repeats=10, warmup=2):
    """Mean device time of function() in ms, by CUDA events"""
    for _ in range(warmup):
        function()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        function()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def harmonic_track(seconds, sample_rate, hopsize):
    """Fundamental of `harmonic_audio` at the frame centers, in Hz"""
    frames = int(seconds * sample_rate) // hopsize
    centers = (np.arange(frames) + 0.5) * hopsize / sample_rate
    return 180. + 60. * np.sin(2 * np.pi * 1.5 * centers)


def logfreq_observations(torch, rng, frames, frequencies):
    """K3 check inputs over one frequency axis: random, tie-heavy, masked,
    and masked with a NaN frame or an all -inf frame

    The masked one is built as `preprocess.harmonics.viterbi` builds the
    second harmonic's: magnitudes kept inside the band 1.8..2.25 times a
    moving fundamental, -inf outside, then a log-softmax.
    """
    states = len(frequencies)
    magnitudes = torch.from_numpy(
        np.abs(30 * rng.standard_normal((frames, states)))).float()
    f0 = torch.from_numpy(
        180. + 60. * np.sin(np.arange(frames) / 9.)).float()
    axis = torch.from_numpy(frequencies).float()
    low = torch.searchsorted(axis, f0 * 1.8)
    high = torch.searchsorted(axis, f0 * 2.25)
    columns = torch.arange(states)[None]
    band = (columns >= low[:, None]) & (columns < high[:, None])
    masked = torch.log_softmax(
        torch.where(band, magnitudes, -float('inf')), -1)
    # A frame whose band is empty: all NaN once through the log-softmax,
    # as the harmonics path makes it, or all -inf
    nan_frame, empty_band = masked.clone(), masked.clone()
    nan_frame[frames // 2] = float('nan')
    empty_band[frames // 3] = -float('inf')
    return {
        'random': torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((frames, states))).float(), -1),
        'ties': torch.from_numpy(np.round(
            rng.standard_normal((frames, states)))).float(),
        'masked': masked, 'nan_frame': nan_frame, 'empty_band': empty_band}


def block_problem(torch, rng, batch, frames, channels, kernel_size, device):
    weights = torch.from_numpy(
        rng.standard_normal((6, kernel_size, channels, channels)) /
        np.sqrt(kernel_size * channels)).to(device, torch.bfloat16)
    biases = torch.from_numpy(
        0.1 * rng.standard_normal((6, channels))).float().to(device)
    x = torch.from_numpy(rng.standard_normal(
        (batch, frames, channels))).to(device, torch.bfloat16)
    return x, weights, biases


def library_block(torch, x, weights, biases):
    """The same chain through torch.nn.functional.conv1d (cuDNN), bf16"""
    F = torch.nn.functional
    k = weights.shape[1]
    # (conv, k, in, out) → (conv, out, in, k)
    w = weights.permute(0, 3, 2, 1).contiguous()
    b = biases.to(torch.bfloat16)
    x = x.transpose(1, 2)
    for i, d in enumerate(DILATIONS):
        t = F.conv1d(F.leaky_relu(x, 0.1), w[2 * i], b[2 * i],
                     padding=(k - 1) // 2 * d, dilation=d)
        t = F.conv1d(F.leaky_relu(t, 0.1), w[2 * i + 1], b[2 * i + 1],
                     padding=(k - 1) // 2)
        x = x + t
    return x


def block_bound_ms(batch, frames, channels, kernel_size):
    """Least time for one Block: tensor-core flops vs bytes moved once"""
    flops = 2. * batch * frames * channels * channels * kernel_size * 6
    moved = 2. * (2 * batch * frames * channels +
                  6 * kernel_size * channels * channels + 6 * channels)
    return max(flops / PEAK_BF16, moved / PEAK_BYTES) * 1e3, \
        'operations' if flops / PEAK_BF16 > moved / PEAK_BYTES else 'bytes'


def launch_counts(resblock, viterbi):
    return {'resblock': resblock.fused_block.launches,
            'viterbi': viterbi.decode.launches,
            'viterbi_logfreq': viterbi.decode_logfreq.launches}


def reset_launch_counts(resblock, viterbi):
    resblock.fused_block.launches = 0
    viterbi.decode.launches = 0
    viterbi.decode_logfreq.launches = 0


def correlation(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def device_busy(torch, function):
    """Kernels and device time of one function() call under torch.profiler

    Returns {'wall_ms', 'kernels', 'device_busy_ms'}: the host time of the
    profiled call (the profiler's own cost included), the count of device
    events (kernels, copies, fills) and the sum of their durations; the
    last two are None where the profiler recorded no device event.
    """
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as profile:
        start = time.perf_counter()
        function()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [event for event in profile.events()
              if event.device_type == torch.autograd.DeviceType.CUDA]
    return {
        'wall_ms': wall * 1e3,
        'kernels': len(events) if events else None,
        'device_busy_ms': sum(
            event.time_range.elapsed_us() for event in events) / 1e3
        if events else None}


def serving_paths(torch, port, config, device, audio, features, pitch_model,
                  ppg_model, generator):
    """Phases 7 to 11: batched, windowed and exact-state streaming
    synthesis, the FARGAN and Vocos backbones, and the file-level entry
    points, each at full width; returns each path's launch counts"""
    from promonet_tpu_torch.ops import resblock, viterbi
    hopsize, sample_rate = config.HOPSIZE, config.SAMPLE_RATE
    frames = features[1].shape[-1]
    host = [x.cpu().numpy() for x in features]
    path_launches = {}

    def timed(function, calls=2):
        """The last of `calls` calls, each with the counts set to 0 just
        before it: (result, host seconds, launch counts)"""
        for _ in range(calls):
            reset_launch_counts(resblock, viterbi)
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = function()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = launch_counts(resblock, viterbi)
        return result, seconds, counts

    def expect(path, counts, expected):
        path_launches[path] = counts
        if counts != expected:
            raise AssertionError(f'{path} launches {counts}')

    # 7. Eight utterances of one bucket in one generator call: the 10 s
    # audio extended to the 896-frame bucket, at eight pitch shifts, so
    # that no padding enters the comparison with single calls
    bucket = port.data.bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)
    long_audio = harmonic_audio(
        bucket * hopsize / sample_rate + 1., sample_rate)[:, :bucket * hopsize]
    base = port.preprocess.from_audio(
        long_audio, pitch_model, ppg_model, loudness_bands=None,
        config=config, device=device)
    shifts = (-300., -200., -100., 0., 100., 200., 300., 400.)
    sets = [port.edit.from_features(
        *base, pitch_shift_cents=cents, config=config) for cents in shifts]
    speakers = list(range(len(sets)))
    batched, batched_seconds, counts = timed(
        lambda: port.synthesize.from_features_batched(
            sets, generator, speakers=speakers, device=device))
    expect('batched', counts, {'resblock': 12, 'viterbi': 0,
                               'viterbi_logfreq': 0})
    singles, singles_seconds, _ = timed(lambda: [
        port.synthesize.from_features(
            *values, generator=generator, speaker=speaker, device=device)
        for values, speaker in zip(sets, speakers)])
    rows_within = []
    relative_rms = []
    for row, single in zip(batched, singles):
        single = torch.from_numpy(single).to(device)
        rows_within.append(within_bf16_bound(torch, row, single))
        relative_rms.append(float(
            (row - single).pow(2).mean().sqrt() / single.pow(2).mean().sqrt()))
    profiled = device_busy(
        torch, lambda: port.synthesize.from_features_batched(
            sets, generator, speakers=speakers, device=device))
    record = dict(
        phase='batched_path', utterances=len(sets), frames=bucket,
        shape=list(batched.shape), ms_per_call=batched_seconds * 1e3,
        ms_per_utterance=batched_seconds * 1e3 / len(sets),
        single_calls_ms=singles_seconds * 1e3,
        single_ms_per_utterance=singles_seconds * 1e3 / len(sets),
        launches=counts, rows_within_bf16_bound=rows_within,
        row_relative_rms_err=relative_rms, profiled_call=profiled,
        finite=bool(torch.isfinite(batched).all()))
    emit(**record)
    if record['shape'] != [len(sets), 1, bucket * hopsize] or \
            not record['finite'] or not all(rows_within):
        raise AssertionError('batched synthesis is wrong')

    # 8. Windowed streaming of the main path's features in 10-frame pieces
    def stream(streamer, step):
        pieces = [streamer.feed(*(x[:, start:start + step] for x in host))
                  for start in range(0, frames, step)]
        pieces.append(streamer.flush())
        return np.concatenate(pieces, axis=-1)

    streamer = port.synthesize.Streamer(generator, speaker=3, device=device)
    if (bucket, streamer.window) != (BATCHED_BUCKET, STREAM_WINDOW):
        raise AssertionError('K1 was checked at other shapes than these')
    streamed, stream_seconds, counts = timed(lambda: stream(streamer, 10))
    windows = -(-frames // streamer.chunk)
    expect('stream', counts, {'resblock': 12 * windows, 'viterbi': 0,
                              'viterbi_logfreq': 0})
    # One window: a fresh stream fed exactly chunk + right frames
    window = port.synthesize.Streamer(generator, speaker=3, device=device)
    profiled = device_busy(torch, lambda: window.feed(*(
        x[:, :window.chunk + window.right] for x in host)))
    offline = port.synthesize.from_features(
        *features, generator=generator, speaker=3, device=device)
    interior = slice(4096, frames * hopsize - 4096)
    record = dict(
        phase='stream_path', frames=frames, windows=windows,
        window_frames=streamer.window, ms=stream_seconds * 1e3,
        ms_per_window=stream_seconds * 1e3 / windows,
        realtime_factor=frames * hopsize / sample_rate / stream_seconds,
        latency_seconds=streamer.latency_seconds, launches=counts,
        profiled_window=profiled, samples=streamed.shape[-1],
        interior_correlation=correlation(
            streamed[0, interior], offline[0, interior]),
        finite=bool(np.isfinite(streamed).all()))
    emit(**record)
    if streamed.shape != (1, frames * hopsize) or not record['finite'] or \
            record['interior_correlation'] <= 0.9:
        raise AssertionError('streaming synthesis is wrong')

    # 9. FARGAN (configs/fargan.py, bf16): offline, then exact-state
    # streaming in 32-frame chunks
    fargan_config = port.config.load(ROOT / 'configs' / 'fargan.py')
    fargan = port.models.init.seeded(
        port.models.Generator(fargan_config), 4).to(device).eval()
    offline, offline_seconds, counts = timed(
        lambda: port.synthesize.from_features(
            *features, generator=fargan, speaker=3, device=device))
    expect('fargan', counts, {'resblock': 0, 'viterbi': 0,
                              'viterbi_logfreq': 0})
    chunk = 32
    chunked, chunked_seconds, counts = timed(lambda: stream(
        port.synthesize.FARGANStreamer(
            fargan, speaker=3, chunk_frames=chunk, device=device), chunk))
    first_chunk = port.synthesize.FARGANStreamer(
        fargan, speaker=3, chunk_frames=chunk, device=device)
    profiled = device_busy(torch, lambda: first_chunk.feed(*(
        x[:, :chunk] for x in host)))
    if profiled['kernels'] is not None:
        profiled['kernels_per_subframe'] = profiled['kernels'] / (
            chunk * fargan.backbone.subframes)
    difference = np.abs(chunked - offline)
    record = dict(
        phase='fargan_path', frames=frames, dtype=fargan_config.PRECISION,
        offline_ms=offline_seconds * 1e3,
        offline_realtime_factor=(
            frames * hopsize / sample_rate / offline_seconds),
        chunk_frames=chunk, chunked_ms=chunked_seconds * 1e3,
        ms_per_chunk=chunked_seconds * 1e3 / -(-frames // chunk),
        chunked_launches=counts, profiled_chunk=profiled,
        first_4_frames_max_abs_err=float(difference[..., :4 * hopsize].max()),
        max_abs_err=float(difference.max()),
        correlation=correlation(chunked, offline),
        peak=float(np.abs(offline).max()),
        finite=bool(np.isfinite(offline).all() and np.isfinite(chunked).all()))
    record['within_stated_bound'] = (
        record['first_4_frames_max_abs_err'] <= FARGAN_FIRST_FRAMES_BOUND and
        record['max_abs_err'] <= FARGAN_MAX_ABS_BOUND and
        record['correlation'] >= FARGAN_CORRELATION_BOUND)
    emit(**record)
    if offline.shape != chunked.shape or offline.shape != (
            1, frames * hopsize) or not record['finite'] or \
            not record['within_stated_bound']:
        raise AssertionError('FARGAN synthesis is wrong')

    # 10. Vocos (configs/baselines/vocos.py, bf16)
    vocos_config = port.config.load(
        ROOT / 'configs' / 'baselines' / 'vocos.py')
    vocos = port.models.init.seeded(
        port.models.Generator(vocos_config), 5).to(device).eval()
    output, vocos_seconds, counts = timed(
        lambda: port.synthesize.from_features(
            *features, generator=vocos, speaker=3, device=device))
    expect('vocos', counts, {'resblock': 0, 'viterbi': 0,
                             'viterbi_logfreq': 0})
    profiled = device_busy(torch, lambda: port.synthesize.from_features(
        *features, generator=vocos, speaker=3, device=device))
    record = dict(
        phase='vocos_path', frames=frames, ms=vocos_seconds * 1e3,
        profiled_call=profiled,
        realtime_factor=frames * hopsize / sample_rate / vocos_seconds,
        samples=output.shape[-1], finite=bool(np.isfinite(output).all()))
    emit(**record)
    if output.shape != (1, frames * hopsize) or not record['finite']:
        raise AssertionError('Vocos synthesis is wrong')

    # 11. Files: wav → features → edited features → wav, and the harmonic
    # contours from the wav and the saved pitch
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        wav = directory / 'speech.wav'
        port.utils.audio.save(wav, audio, sample_rate)
        infix = '-viterbi' if config.VITERBI_DECODE_PITCH else ''

        def inputs(prefix):
            return [directory / f'{prefix}{name}.npy' for name in (
                '-loudness', f'{infix}-pitch', f'{infix}-periodicity', '-ppg')]

        def files():
            stage_ms = {}
            start = time.perf_counter()
            for stage, function in (
                ('preprocess', lambda: port.preprocess.from_file_to_file(
                    wav, pitch_model, ppg_model, config=config,
                    device=device)),
                ('harmonics', lambda: port.preprocess.harmonics.
                    from_file_to_file(
                        wav, directory / 'speech-harmonics.npy',
                        pitch_file=inputs('speech')[1], config=config,
                        device=device)),
                ('edit', lambda: port.edit.from_file_to_file(
                    *inputs('speech'), directory / 'edited', config=config,
                    device=device, **EDIT)),
                ('synthesize', lambda: port.synthesize.from_file_to_file(
                    *inputs('edited'), directory / 'edited.wav', generator,
                    speaker=3, device=device))):
                function()
                torch.cuda.synchronize()
                stage_ms[stage] = (time.perf_counter() - start) * 1e3
                start = time.perf_counter()
            return stage_ms

        stage_ms, file_seconds, counts = timed(files)
        expect('file', counts, {'resblock': 12, 'viterbi': 1,
                                'viterbi_logfreq': 1})
        names = sorted(path.name for path in directory.iterdir())
        expected = sorted(
            [path.name for path in inputs('speech') + inputs('edited')] +
            ['speech.wav', 'speech-harmonics.npy', 'edited.wav'])
        edited_audio, rate = port.utils.audio.load(directory / 'edited.wav')
        harmonics = port.load.array(directory / 'speech-harmonics.npy')
        out_frames = round(frames * 1.4)
        # The edit stage computes on the card, and what it wrote is that
        edited = port.edit.from_file(
            *inputs('speech'), config=config, device=device, **EDIT)
        edited_on = sorted({value.device.type for value in edited})
        edited_as_written = all(
            np.array_equal(value.cpu().numpy(), port.load.array(file))
            for value, file in zip(edited, inputs('edited')))
        record = dict(
            phase='file_path', ms=file_seconds * 1e3, stage_ms=stage_ms,
            files=names, names_as_expected=names == expected,
            samples=edited_audio.shape[-1], sample_rate=rate,
            harmonics_shape=list(harmonics.shape), launches=counts,
            edited_on=edited_on, edited_as_written=edited_as_written)
        emit(**record)
        if edited_on != ['cuda'] or not edited_as_written:
            raise AssertionError('the file edit did not run on the card')
        if names != expected or rate != sample_rate or \
                edited_audio.shape != (1, out_frames * hopsize) or \
                harmonics.shape != (config.MAX_HARMONICS, frames):
            raise AssertionError('file-level entry points are wrong')
    return path_launches


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False); nothing was run', file=sys.stderr)
        return 1
    if not (ROOT / 'promonet_tpu_torch' / 'csrc').is_dir():
        print('chip_smoke: run from a checkout of the repository '
              '(promonet_tpu_torch/ not found)', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import promonet_tpu_torch as port
    from promonet_tpu_torch.ops import _build, resblock, viterbi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else 'nvidia-smi: no output'
    emit(phase='device', name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Build
    start = time.perf_counter()
    reports = _build.build(['resblock', 'viterbi', 'viterbi_logfreq'])
    emit(phase='build', seconds=time.perf_counter() - start,
         ptxas={
             kernel: [line.strip() for line in report.splitlines()
                      if 'registers' in line or 'spill' in line
                      or 'warning' in line.lower()]
             for kernel, report in reports.items()})

    config = port.config.load()
    rng = np.random.default_rng(0)

    # 3. Kernels against their plain versions
    bucket_in = port.data.bucket_frames(
        int(10 * config.SAMPLE_RATE) // config.HOPSIZE,
        config.INFERENCE_FRAME_BUCKETS)
    bucket_out = port.data.bucket_frames(
        round(int(10 * config.SAMPLE_RATE) // config.HOPSIZE * 1.4),
        config.INFERENCE_FRAME_BUCKETS)
    def stage_shapes(frames):
        """(samples, channels) of each upsampling stage's Blocks"""
        shapes, channels = [], config.HIFIGAN_UPSAMPLE_INITIAL_SIZE
        for rate in config.HIFIGAN_UPSAMPLE_RATES:
            channels, frames = channels // 2, frames * rate
            shapes.append((frames, channels))
        return shapes

    shapes = stage_shapes(bucket_out)  # at the main path's synthesis bucket
    k1_error = 0.
    # (frames, channels, kernel sizes, (batch, length) pairs): the main
    # path's shapes with ragged batches, the batched path's at batch 8,
    # one streaming window's, then an odd width
    k1_checks = [
        (frames, channels, KERNEL_SIZES,
         ((1, frames), (4, frames // 16 + 37)))
        for frames, channels in shapes]
    k1_checks += [
        (frames, channels, KERNEL_SIZES, ((8, frames),))
        for frames, channels in stage_shapes(BATCHED_BUCKET)]
    k1_checks += [
        (frames, channels, KERNEL_SIZES, ((1, frames),))
        for frames, channels in stage_shapes(STREAM_WINDOW)]
    k1_checks.append((1000, 48, (7,), ((2, 1000),)))
    # The fused pair keeps 128 - (k - 1) rows per thread block at 128
    # channels: a length below one block, one that ends three rows into
    # the second block (inside the first one's recomputed halo), and one
    # shorter than the halo itself
    k1_checks.append((70, 128, (11,), ((2, 70), (2, 121))))
    k1_checks.append((5, 64, (11,), ((3, 5),)))
    for frames, channels, kernel_sizes, sizes in k1_checks:
        for kernel_size in kernel_sizes:
            for batch, length in sizes:
                x, weights, biases = block_problem(
                    torch, rng, batch, length, channels, kernel_size, device)
                plain = resblock.reference_block(
                    x, weights, biases, DILATIONS, 0.1, torch.bfloat16
                ).float()
                kernel = resblock.fused_block(
                    x, weights, biases, DILATIONS, 0.1).float()
                torch.cuda.synchronize()
                error = (kernel - plain).abs()
                within = within_bf16_bound(torch, kernel, plain)
                record = dict(
                    phase='check', kernel='resblock', batch=batch,
                    frames=length, channels=channels,
                    kernel_size=kernel_size,
                    max_abs_err=float(error.max()), within_bound=within)
                if batch > 1:
                    broken = biases.clone()
                    broken[5, torch.argmax(broken[5].abs())] = 0.
                    wrong = resblock.fused_block(
                        x, weights, broken, DILATIONS, 0.1).float()
                    record['zeroed_bias_caught'] = not within_bf16_bound(
                        torch, wrong, plain)
                    within = within and record['zeroed_bias_caught']
                emit(**record)
                if not within:
                    raise AssertionError('resblock kernel disagrees')
                if batch == 1:
                    k1_error = max(k1_error, record['max_abs_err'])

    transition = viterbi.triangular_transition(256, 9.).to(device)
    initial = torch.full(
        (256,), -float(np.log(np.float32(256))), device=device)
    def random_observation(frames):
        return torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((frames, 256))).float(), -1)

    masked = random_observation(bucket_in)
    masked[torch.from_numpy(rng.random((bucket_in, 256)) < 0.5)] = \
        -float('inf')
    masked[bucket_in // 3] = -float('inf')
    nan_frame = random_observation(bucket_in)
    nan_frame[bucket_in // 2] = float('nan')
    ties = torch.from_numpy(np.round(
        rng.standard_normal((bucket_in, 256)))).float()
    all_equal = torch.zeros(256, 256, device=device)
    random_dense = torch.from_numpy(
        rng.standard_normal((256, 256))).float().to(device)
    observations = {'random': random_observation(bucket_in)}
    # (label, observation, transition)
    k2_checks = [
        ('random', observations['random'], transition),
        ('ties', ties, transition),
        ('one_frame', torch.zeros(1, 256), transition),
        ('two_frames', random_observation(2), transition),
        ('4096_frames', random_observation(4096), transition),
        ('minus_inf', masked, transition),
        ('nan_frame', nan_frame, transition),
        ('all_equal_transition', ties[:300], all_equal),
        ('random_dense_transition', random_observation(100), random_dense),
        ('batch_of_3', torch.stack([
            random_observation(bucket_in), ties, nan_frame]), transition)]
    k2_error = 0
    for label, observation, matrix in k2_checks:
        batch = observation if observation.dim() == 3 else observation[None]
        plain = np.stack([viterbi.decode(
            sequence, matrix.cpu(), initial.cpu()).numpy()
            for sequence in batch])
        on_card_plain = np.stack([
            viterbi.backtrace_plain(*viterbi.forward_plain(
                sequence.to(device), matrix, initial)).cpu().numpy()
            for sequence in batch])
        kernel = viterbi.decode(
            observation.to(device), matrix, initial).cpu().numpy()
        kernel = kernel.reshape(plain.shape)
        equal = bool(np.array_equal(kernel, plain) and
                     np.array_equal(kernel, on_card_plain))
        emit(phase='check', kernel='viterbi', observation=label,
             frames=observation.shape[-2], equal=equal,
             mismatches=int((kernel != plain).sum()))
        k2_error = max(
            k2_error, int(np.abs(kernel - plain).max()),
            int(np.abs(kernel - on_card_plain).max()))
        if not equal:
            raise AssertionError('viterbi kernel disagrees')

    # K3 on the harmonics path's frequency axis, against the plain scan
    # over the dense transition on the card (and on the CPU where small)
    _, stft_axis = port.preprocess.harmonics.stft_features(
        np.zeros((1, 4 * config.HOPSIZE), np.float32), config=config,
        device=device)
    frames_10s = int(10 * config.SAMPLE_RATE) // config.HOPSIZE
    full = logfreq_observations(torch, rng, frames_10s, stft_axis)
    small_axis = np.linspace(50., 8000., 200)
    long_axis = np.linspace(50., 8000., 3000)
    # (label, observation, axis, route override)
    k3_checks = [
        (label, observation, stft_axis, None)
        for label, observation in full.items()]
    k3_checks += [
        ('batch_of_2', torch.stack([full['random'], full['nan_frame']]),
         stft_axis, None),
        ('two_frames', full['random'][:2], stft_axis, None),
        ('grid_route', full['masked'][:120], stft_axis, 'grid'),
        ('small', logfreq_observations(
            torch, rng, 70, small_axis)['random'], small_axis, None),
        ('one_frame', logfreq_observations(
            torch, rng, 1, small_axis)['random'], small_axis, None),
        ('long_axis', logfreq_observations(
            torch, rng, 40, long_axis)['masked'], long_axis, None)]
    k3_observation = full['random'].to(device)
    k3_route = viterbi.logfreq_route(stft_axis, device)
    k3_routes = {
        'stft': k3_route,
        'small': viterbi.logfreq_route(small_axis, device),
        'long': viterbi.logfreq_route(long_axis, device)}
    emit(phase='check', kernel='viterbi_logfreq', routes=k3_routes)
    if k3_route[0] != 'cluster' or k3_routes['small'] != ('cluster', 1) \
            or k3_routes['long'][0] != 'grid':
        raise AssertionError(f'viterbi_logfreq routes {k3_routes}')
    k3_error = 0
    for label, observation, axis, route in k3_checks:
        states = len(axis)
        log_initial = torch.log_softmax(
            torch.linspace(0., -7., states), -1).to(device)
        dense = viterbi.logfreq_transition_dense(axis).to(device)
        batch = observation if observation.dim() == 3 else observation[None]
        on_card_plain = np.stack([
            viterbi.backtrace_plain(*viterbi.forward_plain(
                sequence.to(device), dense, log_initial)).cpu().numpy()
            for sequence in batch])
        routes_before = dict(viterbi.decode_logfreq.routes)
        if route is None:
            kernel = viterbi.decode_logfreq(
                observation.to(device), axis, log_initial)
        else:
            kernel = viterbi._decode_logfreq_cuda(
                observation.to(device), axis, log_initial, 3.5, route=route)
        torch.cuda.synchronize()
        taken = [name for name, count in viterbi.decode_logfreq.routes.items()
                 if count > routes_before[name]]
        kernel = kernel.cpu().numpy().reshape(on_card_plain.shape)
        equal = bool(np.array_equal(kernel, on_card_plain))
        if label == 'batch_of_2':
            singles = np.stack([
                viterbi.decode_logfreq(
                    sequence.to(device), axis, log_initial).cpu().numpy()
                for sequence in batch])
            equal = equal and bool(np.array_equal(kernel, singles))
        if states == 200:
            plain = viterbi.decode_logfreq(
                observation, axis, log_initial.cpu()).numpy()
            equal = equal and bool(np.array_equal(kernel[0], plain))
        emit(phase='check', kernel='viterbi_logfreq', observation=label,
             frames=observation.shape[-2], states=states, route=taken,
             equal=equal, mismatches=int((kernel != on_card_plain).sum()))
        k3_error = max(k3_error, int(np.abs(kernel - on_card_plain).max()))
        if not equal:
            raise AssertionError('viterbi_logfreq kernel disagrees')
    del dense

    # 4. Main path at full width
    pitch_model = port.models.init.seeded(
        port.preprocess.PitchCNN(), 1).to(device).eval()
    ppg_model = port.models.init.seeded(
        port.preprocess.PPGEncoder(), 2).to(device).eval()
    generator = port.models.init.seeded(
        port.models.Generator(config), 3).to(device).eval()
    audio = harmonic_audio(10., config.SAMPLE_RATE)

    def chain(audio, device=device, pitch_model=pitch_model,
              ppg_model=ppg_model, generator=generator, config=config):
        features = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device)
        edited = port.edit.from_features(*features, config=config, **EDIT)
        output = port.synthesize.from_features(
            *edited, generator=generator, speaker=3, device=device)
        return features, edited, output

    launches = {}
    for call in (1, 2):
        resblock.fused_block.launches = 0
        viterbi.decode.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        features, edited, output = chain(audio)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {'resblock': resblock.fused_block.launches,
                    'viterbi': viterbi.decode.launches}
        frames = edited[1].shape[-1]
        finite = bool(np.isfinite(output).all())
        emit(phase='main_path', call=call, seconds=seconds,
             audio_seconds=audio.shape[-1] / config.SAMPLE_RATE,
             realtime_factor=audio.shape[-1] / config.SAMPLE_RATE / seconds,
             input_frames=features[1].shape[-1], output_frames=frames,
             samples=output.shape[-1], finite=finite, launches=launches,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if not finite or output.shape != (1, frames * config.HOPSIZE):
            raise AssertionError('main path output is wrong')
        if launches != {'resblock': 12, 'viterbi': 1}:
            raise AssertionError(f'main path launches {launches}')

    # Per-stage device time of the main path (second call's inputs)
    stage_ms = {
        'preprocess': elapsed_ms(torch, lambda: port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device), repeats=3, warmup=1),
        'edit': elapsed_ms(torch, lambda: port.edit.from_features(
            *features, config=config, **EDIT), repeats=3, warmup=1),
        'synthesize': elapsed_ms(torch, lambda: port.synthesize.from_features(
            *edited, generator=generator, speaker=3, device=device),
            repeats=3, warmup=1)}
    emit(phase='main_path_stages', ms=stage_ms)

    # 5. Reference: a small input through the plain CPU path in float32
    # with the same weights. Loudness and PPG do not depend on the decoded
    # pitch path and must agree; pitch and periodicity are reported as the
    # share of frames that agree (random weights leave the Viterbi scores
    # nearly flat, so a float32 sum order can move the path). Both
    # generators then synthesize the CPU's edited features, so the audio
    # comparison sees the generator alone.
    small = harmonic_audio(0.5, config.SAMPLE_RATE)
    cpu32 = config.replace(PRECISION='float32')
    reference_generator = port.models.Generator(cpu32)
    reference_generator.load_state_dict(
        {k: v.cpu() for k, v in generator.state_dict().items()})
    ours = [x.cpu() for x in port.preprocess.from_audio(
        small, pitch_model, ppg_model, loudness_bands=None, config=config,
        device=device)]
    pitch_cpu = port.models.init.seeded(port.preprocess.PitchCNN(), 1)
    ppg_cpu = port.models.init.seeded(port.preprocess.PPGEncoder(), 2)
    theirs = port.preprocess.from_audio(
        small, pitch_cpu, ppg_cpu, loudness_bands=None, config=cpu32,
        device='cpu')
    edited = port.edit.from_features(*theirs, config=cpu32, **EDIT)
    audio_card = port.synthesize.from_features(
        *[x.to(device) for x in edited], generator=generator, speaker=3,
        device=device)
    audio_cpu = port.synthesize.from_features(
        *edited, generator=reference_generator, speaker=3, device='cpu')
    cents = 1200 * torch.abs(torch.log2(ours[1] / theirs[1]))
    relative_rms = float(
        np.sqrt(np.mean((audio_card - audio_cpu) ** 2) /
                np.mean(audio_cpu ** 2)))
    record = dict(
        phase='reference',
        loudness_max_abs_db=float((ours[0] - theirs[0]).abs().max()),
        ppg_max_abs=float((ours[3] - theirs[3]).abs().max()),
        pitch_share_within_1_cent=float((cents < 1).float().mean()),
        periodicity_share_within_0_001=float(
            ((ours[2] - theirs[2]).abs() < 1e-3).float().mean()),
        audio_relative_rms_err=relative_rms)
    record['agree'] = (
        audio_card.shape == audio_cpu.shape and
        bool(np.isfinite(audio_card).all()) and relative_rms < 0.05 and
        record['loudness_max_abs_db'] < 0.05 and record['ppg_max_abs'] < 1e-3)
    emit(**record)
    if not record['agree']:
        raise AssertionError('card and CPU reference disagree')

    # 6. Second path: harmonic contours, then audio in → edited audio out
    all_features = port.preprocess.core.FEATURES
    harmonics_module = port.preprocess.harmonics
    for call in (1, 2):
        resblock.fused_block.launches = 0
        viterbi.decode.launches = 0
        viterbi.decode_logfreq.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        contours = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, features=all_features,
            config=config, device=device)[-1]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        harmonics_launches = {
            'resblock': resblock.fused_block.launches,
            'viterbi': viterbi.decode.launches,
            'viterbi_logfreq': viterbi.decode_logfreq.launches}
        track = harmonic_track(10., config.SAMPLE_RATE, config.HOPSIZE)
        median_error_hz = [
            float(np.median(np.abs(
                contours[k].cpu().numpy() - (k + 1) * track)))
            for k in range(config.MAX_HARMONICS)]
        bin_hz = float(stft_axis[1] - stft_axis[0])
        finite = bool(torch.isfinite(contours).all())
        emit(phase='harmonics_path', call=call, seconds=seconds,
             shape=list(contours.shape), finite=finite, bin_hz=bin_hz,
             median_error_hz=median_error_hz, launches=harmonics_launches,
             logfreq_decodes=config.MAX_HARMONICS)
        if tuple(contours.shape) != (config.MAX_HARMONICS, frames_10s) \
                or not finite or max(median_error_hz) > 3 * bin_hz:
            raise AssertionError('harmonic contours are wrong')
        # F0, then every other harmonic in one batched launch
        if harmonics_launches != {
                'resblock': 0, 'viterbi': 1,
                'viterbi_logfreq': 1 + (config.MAX_HARMONICS > 1)}:
            raise AssertionError(f'harmonics launches {harmonics_launches}')
    launches['viterbi_logfreq'] = harmonics_launches['viterbi_logfreq']
    harmonics_ms = elapsed_ms(torch, lambda: harmonics_module.from_audio(
        audio, config=config, device=device), repeats=3, warmup=1)

    # The 10 s STFT frames decoded by `harmonics.viterbi` through the kernel
    # and through the plain scan over the dense transition, both on the
    # card: the mask, the initial distribution and the cached band table
    # are the path's own, and the contours must be equal
    spectra, axis = harmonics_module.stft_features(
        audio, config=config, device=device)
    through_kernel = harmonics_module.viterbi(spectra, axis)
    dense = viterbi.logfreq_transition_dense(axis).to(device)

    def plain_logfreq(observation, frequencies, initial):
        if observation.dim() == 3:
            return torch.stack([
                plain_logfreq(sequence, frequencies, initial)
                for sequence in observation])
        return viterbi.backtrace_plain(
            *viterbi.forward_plain(observation, dense, initial))

    kernel_logfreq = viterbi.decode_logfreq
    viterbi.decode_logfreq = plain_logfreq
    try:
        through_plain = harmonics_module.viterbi(spectra, axis)
    finally:
        viterbi.decode_logfreq = kernel_logfreq
    del dense
    differing = int((through_kernel != through_plain).sum())
    nearest = torch.from_numpy(axis).to(device)
    k3_error = max(k3_error, int((
        torch.searchsorted(nearest, through_kernel.contiguous()) -
        torch.searchsorted(nearest, through_plain.contiguous())
    ).abs().max()))
    emit(phase='harmonics_full_width_reference', frames=spectra.shape[0],
         states=spectra.shape[1], differing_frames=differing,
         equal=differing == 0)
    if differing:
        raise AssertionError('kernel and plain harmonics disagree')

    # The same STFT frames decoded on the card and by the plain CPU path
    spectra, axis = harmonics_module.stft_features(
        small, config=config, device=device)
    on_card = harmonics_module.viterbi(spectra, axis).cpu().numpy()
    on_cpu = harmonics_module.viterbi(spectra.cpu(), axis).numpy()
    whole = harmonics_module.from_audio(small, config=config, device='cpu')
    record = dict(
        phase='harmonics_reference', frames=spectra.shape[0],
        equal=bool(np.array_equal(on_card, on_cpu)),
        share_equal_from_audio=float(
            (harmonics_module.from_audio(
                small, config=config, device=device).cpu() == whole
             ).float().mean()))
    emit(**record)
    if not record['equal']:
        raise AssertionError('card and CPU harmonics disagree')

    out_frames = round(frames_10s * 1.4)
    edited_ms = {}
    for label, edit_config, extra in (
        ('default', config, {}),
        ('dsp_selective', config.replace(PITCH_ESTIMATOR='dsp'),
         {'stretch_unvoiced': False}),
    ):
        generator.config = edit_config
        for call in (1, 2):
            resblock.fused_block.launches = 0
            viterbi.decode.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            output = port.synthesize.from_edited_audio(
                audio, pitch_model, ppg_model, generator, speaker=3,
                device=device, **EDIT, **extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            edit_launches = {'resblock': resblock.fused_block.launches,
                             'viterbi': viterbi.decode.launches}
            finite = bool(np.isfinite(output).all())
            emit(phase='from_edited_audio', path=label, call=call,
                 seconds=seconds, samples=output.shape[-1], finite=finite,
                 realtime_factor=10. / seconds, launches=edit_launches)
            if not finite or \
                    output.shape != (1, out_frames * config.HOPSIZE):
                raise AssertionError('from_edited_audio output is wrong')
            if edit_launches != {'resblock': 12, 'viterbi': 1}:
                raise AssertionError(
                    f'from_edited_audio launches {edit_launches}')
        edited_ms[label] = seconds * 1e3
    generator.config = config
    emit(phase='second_path_stages', harmonics_ms=harmonics_ms,
         from_edited_audio_ms=edited_ms)

    # 7 to 11. The rest of the serving surface
    path_launches = serving_paths(
        torch, port, config, device, audio, features, pitch_model, ppg_model,
        generator)
    emit(phase='serving_paths', launches=path_launches)

    # 7. Kernel times at the main path's shapes
    k1 = dict(ms=0., plain_ms=0., library_ms=0., bound_ms=0.)
    bound_by_kind = {'operations': 0., 'bytes': 0.}
    for frames, channels in shapes:
        for kernel_size in KERNEL_SIZES:
            x, weights, biases = block_problem(
                torch, rng, 1, frames, channels, kernel_size, device)
            launches_before = resblock.fused_block.launches
            # Packed once, as `models.hifigan.Block` does
            packed = resblock.pack_weights(weights, biases)
            ms_by_tiles = {
                tiles: elapsed_ms(torch, lambda: resblock.fused_block(
                    x, packed, None, DILATIONS, 0.1, tiles=tiles))
                for tiles in ((1, 2, 4) if channels <= 64 else (1, 2))}
            times = dict(
                ms=elapsed_ms(torch, lambda: resblock.fused_block(
                    x, packed, None, DILATIONS, 0.1)),
                plain_ms=elapsed_ms(torch, lambda: resblock.reference_block(
                    x, weights, biases, DILATIONS, 0.1, torch.bfloat16),
                    repeats=2, warmup=1),
                library_ms=elapsed_ms(
                    torch, lambda: library_block(torch, x, weights, biases)))
            resblock.fused_block.launches = launches_before
            bound, kind = block_bound_ms(1, frames, channels, kernel_size)
            bound_by_kind[kind] += bound
            flops = 2. * frames * channels * channels * kernel_size * 6
            emit(phase='time', kernel='resblock', frames=frames,
                 channels=channels, kernel_size=kernel_size, bound_ms=bound,
                 bound_by=kind, tflops=flops / times['ms'] / 1e9,
                 cuda_launches_per_block=resblock.kernel_launches(
                     channels, DILATIONS),
                 row_tiles=resblock.choose_tiles(channels),
                 ms_by_tiles=ms_by_tiles, **times)
            for key, value in times.items():
                k1[key] += value
            k1['bound_ms'] += bound

    observation = observations['random'].to(device)
    # The analysed transition, as `preprocess.pitch.decode` holds it
    band = viterbi.banded(transition)
    launches_before = viterbi.decode.launches
    k2_ms = elapsed_ms(
        torch, lambda: viterbi.decode(observation, band, initial))
    k2_forward_ms = elapsed_ms(torch, lambda: viterbi._decode_cuda(
        observation, band, initial, phases=1))
    scratch = viterbi._decode_cuda(observation, band, initial, phases=1)
    k2_backtrace_ms = elapsed_ms(torch, lambda: viterbi._decode_cuda(
        observation, band, initial, phases=2, scratch=scratch))
    long_observation = next(
        observation for label, observation, _ in k2_checks
        if label == '4096_frames').to(device)
    k2_long_ms = elapsed_ms(
        torch, lambda: viterbi.decode(long_observation, band, initial))
    viterbi.decode.launches = launches_before
    k2_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            observation, transition, initial)), repeats=2, warmup=1)
    emit(phase='time', kernel='viterbi', frames=observation.shape[0],
         states=observation.shape[1], ms=k2_ms, forward_ms=k2_forward_ms,
         backtrace_ms=k2_backtrace_ms, plain_ms=k2_plain_ms,
         us_per_frame=1e3 * k2_forward_ms / (observation.shape[0] - 1),
         ms_at_4096_frames=k2_long_ms,
         band_entries=band.entries, table_in_shared=band.table_in_shared)
    # Operations this data needs: one add and one compare per candidate
    # inside the transition's band (entries at the -1e30 floor never win)
    states = observation.shape[1]
    band = int((transition > viterbi.NEG_INF / 2).sum())
    k2_ops = 2. * (observation.shape[0] - 1) * band
    k2_bytes = 4. * (observation.numel() + states * states + states +
                     observation.shape[0])
    log_initial = torch.log_softmax(
        torch.linspace(0., -7., len(stft_axis)), -1).to(device)
    launches_before = viterbi.decode_logfreq.launches
    k3_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        k3_observation, stft_axis, log_initial))
    k3_forward_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=1))
    scratch = viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=1)
    k3_backtrace_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=2,
        scratch=scratch))
    k3_pair = torch.stack([k3_observation, k3_observation.flip(0)])
    k3_pair_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        k3_pair, stft_axis, log_initial))
    k3_grid_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, route='grid'))
    dense = viterbi.logfreq_transition_dense(stft_axis).to(device)
    k3_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            k3_observation, dense, log_initial)), repeats=2, warmup=1)
    del dense
    # Operations this data needs: one add and one compare per frame for
    # every (source, destination) pair inside the band table's runs.
    # Bytes moved once: observation and initial in, two-byte predecessors
    # and the path out, the band table with its offsets and first sources
    # in.
    table_values, table_offsets, _, _ = viterbi.band_table(stft_axis)
    k3_frames, k3_states = k3_observation.shape
    k3_ops = 2. * (k3_frames - 1) * len(table_values)
    k3_bytes = (
        4. * (k3_frames * k3_states + k3_states + k3_frames +
              len(table_values) + len(table_offsets) + k3_states) +
        viterbi.logfreq_entry_dtype(k3_states).itemsize *
        (k3_frames - 1) * k3_states)
    # The same number of frames over 200 states: next to no work per
    # frame, so what is left is the per-frame latency (two block barriers
    # and the hand-over of alpha), by cluster size
    narrow_axis = np.linspace(50., 8000., 200)
    narrow = k3_observation[:, :200].contiguous()
    narrow_initial = log_initial[:200].contiguous()
    k3_narrow_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        narrow, narrow_axis, narrow_initial))
    k3_narrow_ms_by_cluster = {
        blocks: elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
            narrow, narrow_axis, narrow_initial, 3.5, route=blocks))
        for blocks in (1, 2, 4)}
    # The reading behind `viterbi.DESTINATION_ROWS`, the cost of a
    # destination in table rows when the groups are split over a cluster's
    # blocks: the same decode with other values, each on a plan built anew
    k3_ms_by_destination_rows = {viterbi.DESTINATION_ROWS: k3_ms}
    destination_rows = viterbi.DESTINATION_ROWS
    try:
        for value in (0, destination_rows // 4, 4 * destination_rows):
            viterbi.DESTINATION_ROWS = value
            viterbi._logfreq_plan_on.cache_clear()
            k3_ms_by_destination_rows[value] = elapsed_ms(
                torch, lambda: viterbi.decode_logfreq(
                    k3_observation, stft_axis, log_initial))
    finally:
        viterbi.DESTINATION_ROWS = destination_rows
        viterbi._logfreq_plan_on.cache_clear()
    # Where a frame's time goes: the kernel's counting variant reads the
    # clock of thread 0 of the cluster's first and last block around each
    # section of a frame; its path must be the kernel's
    cycles = torch.zeros(
        (2, len(viterbi.LOGFREQ_SECTIONS)), dtype=torch.int64, device=device)
    counted = viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, cycles=cycles)
    uncounted = viterbi.decode_logfreq(k3_observation, stft_axis, log_initial)
    torch.cuda.synchronize()
    if not torch.equal(counted, uncounted):
        raise AssertionError('the counting variant decodes another path')
    k3_cycles_per_frame = {
        block: {
            name: float(count) / (k3_frames - 1)
            for name, count in zip(viterbi.LOGFREQ_SECTIONS, row.tolist())}
        for block, row in zip(('first_block', 'last_block'), cycles.cpu())}
    viterbi.decode_logfreq.launches = launches_before
    emit(phase='time', kernel='viterbi_logfreq', frames=k3_frames,
         states=k3_states, in_band_pairs=len(table_values),
         route=k3_route[0], cluster_blocks=k3_route[1], ms=k3_ms,
         forward_ms=k3_forward_ms, backtrace_ms=k3_backtrace_ms,
         batch_of_2_ms=k3_pair_ms, grid_route_ms=k3_grid_ms,
         plain_ms=k3_plain_ms, operations=k3_ops, bytes=k3_bytes,
         ms_at_200_states=k3_narrow_ms,
         ms_at_200_states_by_cluster_blocks=k3_narrow_ms_by_cluster,
         ms_by_destination_rows=k3_ms_by_destination_rows,
         cycles_per_frame=k3_cycles_per_frame,
         us_per_frame=1e3 * k3_forward_ms / (k3_frames - 1),
         us_per_frame_at_200_states=1e3 * k3_narrow_ms / (k3_frames - 1))
    kernels = [
        dict(name='resblock', route='cuda',
             source='promonet_tpu_torch/csrc/resblock.cu',
             replaces='promonet_tpu/ops/resblock.py:253',
             launches=launches['resblock'], max_abs_err=k1_error,
             ms=k1['ms'], plain_ms=k1['plain_ms'],
             bound_ms=k1['bound_ms'],
             bound_by=max(bound_by_kind, key=bound_by_kind.get),
             library_ms=k1['library_ms']),
        dict(name='viterbi', route='cuda',
             source='promonet_tpu_torch/csrc/viterbi.cu',
             replaces='promonet_tpu/ops/viterbi.py:405',
             launches=launches['viterbi'], max_abs_err=float(k2_error),
             ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=max(k2_ops / PEAK_FP32, k2_bytes / PEAK_BYTES) * 1e3,
             bound_by='operations' if k2_ops / PEAK_FP32 >
             k2_bytes / PEAK_BYTES else 'bytes',
             library_ms=None),
        dict(name='viterbi_logfreq', route='cuda',
             source='promonet_tpu_torch/csrc/viterbi_logfreq.cu',
             replaces='promonet_tpu/ops/viterbi.py:287',
             launches=launches['viterbi_logfreq'],
             max_abs_err=float(k3_error),
             ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=max(k3_ops / PEAK_FP32, k3_bytes / PEAK_BYTES) * 1e3,
             bound_by='operations' if k3_ops / PEAK_FP32 >
             k3_bytes / PEAK_BYTES else 'bytes',
             library_ms=None)]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
