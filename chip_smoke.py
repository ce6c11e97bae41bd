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
   main path's shapes (batch 1) and at ragged lengths (batch 4), bounded
   per element by |kernel - plain| <= 2^-5 * (|plain| + 2 * rms(plain)),
   and the bound must fail once a single bias is zeroed. The Viterbi decode (K2)
   on a random and a tie-heavy (896, 256) observation, paths equal
   exactly. The log-frequency Viterbi decode (K3) on random, tie-heavy
   and -inf-masked (861, 2039) observations over the harmonics path's
   frequency axis, on (70, 200) and on one frame, paths equal exactly.
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
   'harmonics' (the counters must show MAX_HARMONICS log-frequency
   decodes, the contours must be (3, frames), finite and within three
   bins of the signal's harmonics in the median, equal to the contours
   that the plain scan over the dense transition decodes on the card
   from the same 10 s of STFT frames, and on a half-second input equal
   to the plain CPU path's on the same STFT frames), then
   synthesize.from_edited_audio with the defaults and with
   PITCH_ESTIMATOR='dsp' and stretch_unvoiced=False (12 residual-block
   calls and 1 Viterbi decode each, finite audio of
   round(frames * 1.4) * HOPSIZE samples). Second calls are timed.
7. kernels: per kernel its launches, error (for the two decodes the
   largest difference in state index seen in this run's checks), time,
   plain and library times and the card's bound, then the card's name and power limit,
   then {"ok": true, "device": ...} as the last line.

TF32 is off for every comparison (cuDNN and cuBLAS), so float32 work
runs in float32.
"""
import json
import subprocess
import sys
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
BF16_RTOL = 2. ** -5


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
    """K3 check inputs over one frequency axis: random, tie-heavy, masked

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
    return {
        'random': torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((frames, states))).float(), -1),
        'ties': torch.from_numpy(np.round(
            rng.standard_normal((frames, states)))).float(),
        'masked': torch.log_softmax(
            torch.where(band, magnitudes, -float('inf')), -1)}


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
                      if 'registers' in line or 'spill' in line]
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
    shapes = []  # (frames, channels) of each stage at the synthesis bucket
    channels, frames = config.HIFIGAN_UPSAMPLE_INITIAL_SIZE, bucket_out
    for rate in config.HIFIGAN_UPSAMPLE_RATES:
        channels, frames = channels // 2, frames * rate
        shapes.append((frames, channels))
    k1_error = 0.
    for frames, channels in shapes:
        for kernel_size in KERNEL_SIZES:
            for batch, length in ((1, frames), (4, frames // 16 + 37)):
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
                if batch == 4:
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
    observations = {
        'random': torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((bucket_in, 256))).float(), -1),
        'ties': torch.from_numpy(np.round(
            rng.standard_normal((bucket_in, 256)))).float(),
        'one_frame': torch.zeros(1, 256)}
    k2_error = 0
    for label, observation in observations.items():
        plain = viterbi.decode(
            observation, transition.cpu(), initial.cpu()).numpy()
        on_card_plain = viterbi.backtrace_plain(*viterbi.forward_plain(
            observation.to(device), transition, initial)).cpu().numpy()
        kernel = viterbi.decode(
            observation.to(device), transition, initial).cpu().numpy()
        equal = bool(np.array_equal(kernel, plain) and
                     np.array_equal(kernel, on_card_plain))
        emit(phase='check', kernel='viterbi', observation=label,
             frames=observation.shape[0], equal=equal,
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
    k3_checks = [
        (label, observation, stft_axis)
        for label, observation in logfreq_observations(
            torch, rng, frames_10s, stft_axis).items()]
    small_axis = np.linspace(50., 8000., 200)
    k3_checks.append(('small', logfreq_observations(
        torch, rng, 70, small_axis)['random'], small_axis))
    k3_checks.append(('one_frame', logfreq_observations(
        torch, rng, 1, small_axis)['random'], small_axis))
    k3_observation = k3_checks[0][1].to(device)
    k3_error = 0
    for label, observation, axis in k3_checks:
        states = len(axis)
        log_initial = torch.log_softmax(
            torch.linspace(0., -7., states), -1).to(device)
        dense = viterbi.logfreq_transition_dense(axis).to(device)
        on_card_plain = viterbi.backtrace_plain(*viterbi.forward_plain(
            observation.to(device), dense, log_initial)).cpu().numpy()
        kernel = viterbi.decode_logfreq(
            observation.to(device), axis, log_initial).cpu().numpy()
        torch.cuda.synchronize()
        equal = bool(np.array_equal(kernel, on_card_plain))
        if states == 200:
            plain = viterbi.decode_logfreq(
                observation, axis, log_initial.cpu()).numpy()
            equal = equal and bool(np.array_equal(kernel, plain))
        emit(phase='check', kernel='viterbi_logfreq', observation=label,
             frames=observation.shape[0], states=states, equal=equal,
             mismatches=int((kernel != on_card_plain).sum()))
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
             median_error_hz=median_error_hz, launches=harmonics_launches)
        if tuple(contours.shape) != (config.MAX_HARMONICS, frames_10s) \
                or not finite or max(median_error_hz) > 3 * bin_hz:
            raise AssertionError('harmonic contours are wrong')
        if harmonics_launches != {
                'resblock': 0, 'viterbi': 1,
                'viterbi_logfreq': config.MAX_HARMONICS}:
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

    # 7. Kernel times at the main path's shapes
    k1 = dict(ms=0., plain_ms=0., library_ms=0., bound_ms=0.)
    bound_by_kind = {'operations': 0., 'bytes': 0.}
    for frames, channels in shapes:
        for kernel_size in KERNEL_SIZES:
            x, weights, biases = block_problem(
                torch, rng, 1, frames, channels, kernel_size, device)
            launches_before = resblock.fused_block.launches
            times = dict(
                ms=elapsed_ms(torch, lambda: resblock.fused_block(
                    x, weights, biases, DILATIONS, 0.1)),
                plain_ms=elapsed_ms(torch, lambda: resblock.reference_block(
                    x, weights, biases, DILATIONS, 0.1, torch.bfloat16),
                    repeats=3, warmup=1),
                library_ms=elapsed_ms(
                    torch, lambda: library_block(torch, x, weights, biases)))
            resblock.fused_block.launches = launches_before
            bound, kind = block_bound_ms(1, frames, channels, kernel_size)
            bound_by_kind[kind] += bound
            emit(phase='time', kernel='resblock', frames=frames,
                 channels=channels, kernel_size=kernel_size, bound_ms=bound,
                 bound_by=kind, **times)
            for key, value in times.items():
                k1[key] += value
            k1['bound_ms'] += bound

    observation = observations['random'].to(device)
    k2_ms = elapsed_ms(
        torch, lambda: viterbi.decode(observation, transition, initial))
    k2_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            observation, transition, initial)), repeats=2, warmup=1)
    # Operations this data needs: one add and one compare per candidate
    # inside the transition's band (entries at the -1e30 floor never win)
    states = observation.shape[1]
    band = int((transition > viterbi.NEG_INF / 2).sum())
    k2_ops = 2. * (observation.shape[0] - 1) * band
    k2_bytes = 4. * (observation.numel() + states * states + states +
                     observation.shape[0])
    log_initial = torch.log_softmax(
        torch.linspace(0., -7., len(stft_axis)), -1).to(device)
    k3_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        k3_observation, stft_axis, log_initial))
    dense = viterbi.logfreq_transition_dense(stft_axis).to(device)
    k3_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            k3_observation, dense, log_initial)), repeats=2, warmup=1)
    # Operations this data needs: one add and one compare per frame for
    # every (source, destination) pair inside the band table's runs.
    # Bytes moved once: observation and initial in, predecessors and path
    # out, the band table with its offsets and first sources in.
    table_values, table_offsets, _, _ = viterbi.band_table(stft_axis)
    k3_frames, k3_states = k3_observation.shape
    k3_ops = 2. * (k3_frames - 1) * len(table_values)
    k3_bytes = 4. * (
        k3_frames * k3_states + k3_states + (k3_frames - 1) * k3_states +
        k3_frames + len(table_values) + len(table_offsets) + k3_states)
    # The same number of frames over 200 states: next to no work per
    # frame, so what is left is the per-frame latency (barrier, reload)
    narrow_axis = np.linspace(50., 8000., 200)
    narrow = k3_observation[:, :200].contiguous()
    k3_narrow_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        narrow, narrow_axis, log_initial[:200].contiguous()))
    # The reading behind `viterbi.RUN_OVERHEAD`, the fixed cost per
    # destination in the split of the destinations over the blocks: the
    # same decode with the split by run length alone (0) and with twice
    # the fixed cost, each on a band table built anew
    k3_ms_by_run_overhead = {viterbi.RUN_OVERHEAD: k3_ms}
    run_overhead = viterbi.RUN_OVERHEAD
    try:
        for value in (0, 2 * run_overhead):
            viterbi.RUN_OVERHEAD = value
            viterbi._band_table_on.cache_clear()
            k3_ms_by_run_overhead[value] = elapsed_ms(
                torch, lambda: viterbi.decode_logfreq(
                    k3_observation, stft_axis, log_initial))
    finally:
        viterbi.RUN_OVERHEAD = run_overhead
        viterbi._band_table_on.cache_clear()
    emit(phase='time', kernel='viterbi_logfreq', frames=k3_frames,
         states=k3_states, in_band_pairs=len(table_values), ms=k3_ms,
         plain_ms=k3_plain_ms, operations=k3_ops, bytes=k3_bytes,
         ms_at_200_states=k3_narrow_ms,
         ms_by_run_overhead=k3_ms_by_run_overhead,
         us_per_frame=1e3 * k3_ms / (k3_frames - 1),
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
