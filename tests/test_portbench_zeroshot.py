"""The benchmark's zero-shot and data-parallel pieces on the CPU: the new
metric readers on hand-made spans and trace events, the zero-shot cell
run through its driver at a tiny width (the program correct, the
float8 control not), and the data-parallel training cell at two gloo
ranks, each rank a process, held to one process's reference.

This file imports neither JAX nor the JAX package.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'portbench' / 'tests'))

import tiny  # noqa: E402
from portbench import counts, harness, program_spans, trace  # noqa: E402
from portbench.harness import Reading, Window  # noqa: E402
from promonet_tpu_torch.utils.timer import Record  # noqa: E402

import promonet_tpu_torch as port  # noqa: E402

PEAK = {'bfloat16': 989e12, 'tfloat32': 494.7e12, 'float32': 67e12,
        'bytes': 3.35e12}
WINDOW = (0, 10_000)
SIZES = json.loads((ROOT / 'portbench' / 'configs' /
                    'promonet-zeroshot.json').read_text())['wavlm']
CONFIG_FILE = {'wavlm': SIZES, 'vocoder_flops': 'hifigan_flops'}


@pytest.fixture(autouse=True)
def _threads():
    """`tiny.run` sets four threads: later tests of this process get back
    the count they had (subprocess against in-process comparisons elsewhere
    are exact only at one count)"""
    previous = torch.get_num_threads()
    yield
    torch.set_num_threads(previous)


def reader(name):
    path = ROOT / 'portbench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f"test_zeroshot_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record(name, id, parent, start, end, **counts):
    span = Record(name, id, parent, start, counts)
    span.end_ns = end
    return span


SPANS = [
    record('preprocess.speaker', 1, 0, 1000, 5000, samples=48000,
           frames=149),
    record('speaker.features', 2, 1, 1000, 2000),
    record('speaker.encoder', 3, 1, 2000, 4000),
    record('speaker.xvector', 4, 1, 4000, 5000),
    record('preprocess', 5, 0, 5500, 6000),
    record('preprocess.speaker', 6, 0, 7000, 8000, samples=16000,
           frames=49),
    # Another window's span is not read
    record('preprocess.speaker', 7, 0, 20_000, 30_000, samples=16000,
           frames=49),
]

KERNELS = [
    (1500, 3500, 1200, 'ampere_bf16_s16816gemm_bf16_128x64'),
    (3600, 3700, 3000, 'Memcpy HtoD (Pageable -> Device)'),
    (7100, 7300, 7050, 'fmha_cutlassF_bf16_aligned_64x64_rf_sm80'),
    (7400, 7500, 8500, 'vectorized_elementwise_kernel'),    # launched after
    (5600, 5700, 5550, 'conv2d_kernel'),                   # in preprocess
]


def reading(kernels=KERNELS, config_file=CONFIG_FILE, work=None,
            attempted=2, peak=PEAK):
    reduced = trace.Trace(kernels, {'window': [WINDOW]}, WINDOW)
    window = Window(attempted, 0, 1e-5, {}, work or {})
    return Reading(reduced, {}, window, port.config.load(), peak,
                   config_file)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(program_spans, 'records', lambda: list(SPANS))


def test_launches_speaker_counts_kernels_inside_the_spans(spans):
    # Two kernels and a copy were launched inside the two spans
    assert reader('launches.speaker').read(reading()) == pytest.approx(1.)


def test_peak_share_speaker_is_the_least_time_over_the_device_time(spans):
    metric = reader('peak_share.speaker')
    least = (metric.flops(48000, SIZES) + metric.flops(16000, SIZES)) / \
        PEAK['bfloat16']
    device = (2000 + 100 + 200) / 1e9
    assert metric.read(reading()) == pytest.approx(100. * least / device)


def test_wavlm_operations_by_hand():
    """One second of audio: 49 frames; the seven convolutions, the
    projection, the positional convolution, 12 layers and the head"""
    metric = reader('peak_share.speaker')
    lengths, length = [], 16000
    for kernel, stride in zip(SIZES['conv_kernel'], SIZES['conv_stride']):
        length = (length - kernel) // stride + 1
        lengths.append(length)
    assert lengths[-1] == 49
    cnn = 2. * lengths[0] * 512 * 10 + sum(
        2. * n * 512 * 512 * k for n, k in zip(lengths[1:],
                                               SIZES['conv_kernel'][1:]))
    frames = 49
    layers = 12 * (2. * frames * 768 * 768 * 4 + 2. * frames * 768 * 8 +
                   4. * frames * 768 * 3072 + 4. * frames * frames * 768)
    head = 2. * frames * 768 * 512 + 2. * 45 * 512 * 5 * 512 + \
        2. * 41 * 512 * 3 * 512 + 2. * 35 * 512 * 3 * 512 + \
        2. * 35 * 512 * 512 + 2. * 35 * 512 * 1500 + 2. * 3000 * 512
    expected = cnn + 2. * frames * 512 * 768 + \
        2. * frames * 768 * 48 * 128 + layers + head
    assert metric.flops(16000, SIZES) == pytest.approx(expected)


def test_idle_ms_speaker_takes_the_idle_inside_its_spans(spans):
    """Idle inside the first span: 1000-1500, 3500-3600 and 3700-5000;
    inside the second: 7000-7100, 7300-7400 (the late launch still runs
    there) and 7500-8000"""
    idle = (500 + 100 + 1300 + 100 + 100 + 500) / 1e9
    assert reader('idle_ms.speaker').read(reading()) == pytest.approx(
        1e3 * idle / 2)


def test_mfu_zeroshot_adds_wavlm_to_what_mfu_infer_counts():
    config = port.config.load()
    work = {'preprocess_frames': [100, 40], 'generator_calls': [[120], [50]],
            'speaker_samples': [48000, 16000]}
    least = sum(counts.preprocess_least_seconds(frames, PEAK)
                for frames in work['preprocess_frames'])
    least += (counts.hifigan_flops(120, config) +
              counts.hifigan_flops(50, config)) / PEAK['bfloat16']
    flops = reader('peak_share.speaker').flops
    least += (flops(48000, SIZES) + flops(16000, SIZES)) / PEAK['bfloat16']
    found = reader('mfu.zeroshot').read(reading(work=work))
    assert found == pytest.approx(100. * least / 1e-5)
    infer = reader('mfu.infer').read(reading(work=work))
    assert found > infer


@pytest.mark.parametrize('records', [None, [], SPANS[4:5]],
                         ids=['no-spans', 'none-kept', 'no-speaker-span'])
def test_speaker_readers_read_nothing_without_the_spans(monkeypatch,
                                                        records):
    """A program from before the speaker stage's spans, or a window
    without one: each reader returns None and does not raise"""
    monkeypatch.setattr(program_spans, 'records', lambda: records)
    for name in ('launches.speaker', 'peak_share.speaker',
                 'idle_ms.speaker'):
        assert reader(name).read(reading()) is None, name


def test_mfu_zeroshot_needs_the_wavlm_widths():
    work = {'preprocess_frames': [10], 'generator_calls': [[10]]}
    assert reader('mfu.zeroshot').read(reading(
        config_file={'vocoder_flops': 'hifigan_flops'}, work=work)) is None


def test_allreduce_ms_train_sums_the_nccl_kernels_a_step():
    kernels = [
        (100, 400, 50, 'ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)'),
        (500, 600, 450, 'ncclKernel_AllReduce_RING_LL_Sum_float'),
        (700, 900, 650, 'void cudnn::conv_kernel'),
    ]
    found = reader('allreduce_ms.train').read(
        reading(kernels=kernels, work={'steps': 2}))
    assert found == pytest.approx(1e3 * (400 / 1e9) / 2)
    assert reader('allreduce_ms.train').read(
        reading(kernels=kernels[2:], work={'steps': 2})) is None


###############################################################################
# The drivers on the CPU
###############################################################################


SHORT = {'law': 'lognormal', 'median': 0.8, 'sigma': 0.6, 'low': 0.5,
         'high': 1.2}
REFERENCE_SECONDS = {'law': 'lognormal', 'median': 1.0, 'sigma': 0.5,
                     'low': 0.6, 'high': 2.0}
TINY_WAVLM = dict(
    conv_dim=[32, 32, 32], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    pos_kernel=16, pos_groups=4, num_buckets=320, max_distance=800,
    eps=1e-5, tdnn_dim=[32, 32, 32, 32, 64], tdnn_kernel=[5, 3, 3, 1, 1],
    tdnn_dilation=[1, 2, 3, 1, 1], xvector_dim=512)
# Between what the program (bf16 on the CPU) and the control read at
# this size: speaker about 4e-3 against 7e-2
ZEROSHOT_LIMITS = {'loudness_db': 1e-3, 'pitch_path_nats': 1e-3,
                   'pitch_cents': 0.05, 'periodicity': 1e-4, 'ppg': 1e-4,
                   'edit': 1e-5, 'audio': 0.06, 'speaker': 0.02}


def zeroshot_cell(tmp_path):
    benchmark = tiny.root(
        tmp_path, 'edit.single.zeroshot', ZEROSHOT_LIMITS,
        settings='ZERO_SHOT = True\n', overrides={
            'requests': 3, 'checked': 3,
            'bank': {'utterances': 3, 'seconds': 2.5},
            'laws': {'seconds': SHORT,
                     'reference_seconds': REFERENCE_SECONDS}})
    path = tmp_path / 'portbench' / 'configs' / f'{tiny.NAME}.json'
    config_file = json.loads(path.read_text())
    config_file['values']['ZERO_SHOT'] = True
    config_file['wavlm'] = TINY_WAVLM
    path.write_text(json.dumps(config_file))
    return benchmark


@pytest.mark.parametrize('system', ['program', 'control'])
def test_the_zeroshot_cell_judges_program_and_control(tmp_path, system):
    """The program comes out correct with every number under its limit;
    the control in float8 does not, its speaker number among those over"""
    result, checks = tiny.run(zeroshot_cell(tmp_path), tmp_path,
                              seed=2 ** 31 + 12345, system=system)
    numbers = {check.name: check for check in checks}
    assert set(numbers) == set(ZEROSHOT_LIMITS)
    assert result['attempted'] >= 1 and result['failed'] == 0
    if system == 'program':
        assert result['correct'], numbers
    else:
        assert not result['correct']
        assert not numbers['speaker'].passed


def test_requests_take_the_reference_from_another_speaker(tmp_path):
    from portbench.drivers import zeroshot
    cell = harness.Cell(zeroshot_cell(tmp_path), f'{tiny.NAME}.cell',
                        tmp_path)
    config = cell.config()
    first = zeroshot.requests(cell.traffic, 11, config)
    again = zeroshot.requests(cell.traffic, 11, config)
    assert len(first) == 3
    for one, two in zip(first, again):
        assert (one.audio == two.audio).all()
        assert (one.reference == two.reference).all()
        assert 0.6 * config.SAMPLE_RATE <= one.reference.shape[-1] <= \
            2.0 * config.SAMPLE_RATE
        # Cut from another utterance of the bank: no sample run in common
        assert one.reference.shape != one.audio.shape or \
            not (one.reference == one.audio).all()


def test_two_gloo_ranks_train_as_one_process(tmp_path, monkeypatch):
    """The data-parallel cell at two ranks (this process and one more),
    a row each: every number at float32's rounding of the one-process
    reference on the whole batch, and the ranks' parameters bit-equal"""
    limits = {'loss': 1e-4, 'output': 1e-4, 'gradient': 1e-3,
              'change': 1e-3, 'loss.window': 1e-4, 'output.window': 1e-4,
              'gradient.median.window': 1e-3, 'change.window': 1e-3,
              'ranks_differ': 0}
    benchmark = tiny.root(
        tmp_path, 'train.b64.dp4', limits,
        settings="PRECISION = 'float32'\n", overrides={
            'batch': 2, 'chunk': 2048, 'batches': 3, 'warmup_steps': 0,
            'checked_steps': 1, 'world': 2})
    for metric in benchmark['end_to_end']:
        if 'workloads' in metric:
            metric['workloads'] = [f'{tiny.NAME}.cell'] \
                if metric['name'] == 'train_step_ms' else []
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(benchmark))
    # The driver sets these where unset: undone after the test
    for variable in ('NCCL_SOCKET_IFNAME', 'GLOO_SOCKET_IFNAME'):
        monkeypatch.setenv(variable, 'lo')
    cpus = os.sched_getaffinity(0)
    result, checks = tiny.run(benchmark, tmp_path, seed=2 ** 31 + 99,
                              seconds=0.1)
    numbers = {check.name: check.value for check in checks}
    assert result['correct'], numbers
    assert numbers['ranks_differ'] == 0
    assert result['metrics']['train_step_ms']['value'] > 0
    assert not torch.distributed.is_initialized()
    # Bound to cores on a card's host only
    assert os.sched_getaffinity(0) == cpus
