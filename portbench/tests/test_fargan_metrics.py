"""The metrics of FARGAN's frame loop (`fused_share.fargan`,
`k4_roofline`) on hand-made spans and trace kernels, and on a program
that records neither (a window before K4)"""
import importlib.util

import pytest

import tiny
from portbench import program_spans, trace
from portbench.harness import Reading, Window
from promonet_tpu_torch.utils.timer import Record

PEAK = {'bfloat16': 989e12, 'bytes': 3.35e12}
WINDOW = (0, 10_000)
K4 = 'void (anonymous namespace)::fargan_subframe_kernel<4>(Params)'


def reader(name):
    path = tiny.ROOT / 'portbench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f"test_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record(name, id, parent, start, end, **counts):
    span = Record(name, id, parent, start, counts)
    span.end_ns = end
    return span


SPANS = [
    record('vocoder', 1, 0, 100, 4000, frames=8, true_frames=8),
    record('frame_loop', 2, 1, 200, 3000, subframes=96, rows=3, fused=96),
    record('vocoder', 3, 0, 5000, 9000, frames=4, true_frames=4),
    record('frame_loop', 4, 3, 5100, 8000, subframes=16, rows=1, fused=0),
    # Another window's loop is not read
    record('frame_loop', 5, 0, 20_000, 30_000, subframes=64, rows=1,
           fused=64),
]


def reading(kernels, peak=PEAK):
    reduced = trace.Trace(kernels, {'window': [WINDOW]}, WINDOW)
    return Reading(reduced, {}, Window(2, 0, 1e-5, {}), None, peak, {})


def test_fused_share_counts_the_fused_subframes(monkeypatch):
    monkeypatch.setattr(program_spans, 'records', lambda: list(SPANS))
    share = reader('fused_share.fargan').read(reading([]))
    assert share == pytest.approx(100. * 96 / (96 + 16))


@pytest.mark.parametrize('spans', [None, [], SPANS[:1] + SPANS[2:3]],
                         ids=['no-spans', 'none-kept', 'no-frame-loop'])
def test_fused_share_reads_nothing_without_a_frame_loop(monkeypatch, spans):
    monkeypatch.setattr(program_spans, 'records', lambda: spans)
    assert reader('fused_share.fargan').read(reading([])) is None


def test_k4_roofline_takes_each_launch_at_its_loops_rows(monkeypatch):
    monkeypatch.setattr(program_spans, 'records', lambda: list(SPANS))
    metric = reader('k4_roofline')
    kernels = [
        (300, 350, 250, K4),          # in the three-row loop
        (400, 430, 390, K4),
        (6000, 6020, 5500, K4),       # in the one-row loop
        (9500, 9510, 9400, K4),       # in no loop: one row
        (500, 900, 450, 'nvjet_tst_8x64_gemv'),
        (600, 610, 480, 'Memcpy HtoD (Pageable -> Device)'),
    ]
    least = 2 * metric.least_seconds(3, PEAK) + 2 * metric.least_seconds(
        1, PEAK)
    device = (50 + 30 + 20 + 10) / 1e9
    assert metric.read(reading(kernels)) == pytest.approx(
        100. * least / device)


def test_k4_least_time_by_hand():
    """A one-row launch is bound by its bytes: 4,493,312 bytes of bf16
    weights and 6,096 of its row at 3.35 TB/s"""
    metric = reader('k4_roofline')
    assert metric.weights() == 2_246_656
    assert metric.row_bytes() == 6_096
    assert metric.least_seconds(1, PEAK) == pytest.approx(
        (4_493_312 + 6_096) / 3.35e12)
    # Enough rows and the operations bound it
    rows = 10_000
    assert metric.least_seconds(rows, PEAK) == pytest.approx(
        2 * 2_246_656 * rows / 989e12)


@pytest.mark.parametrize('spans', [None, SPANS], ids=['no-spans', 'spans'])
def test_k4_roofline_reads_nothing_without_the_kernel(monkeypatch, spans):
    monkeypatch.setattr(program_spans, 'records', lambda: spans)
    metric = reader('k4_roofline')
    assert metric.read(reading([(0, 10, 0, 'nvjet_tst_8x64_gemv')])) is None
    assert metric.read(reading([(0, 10, 0, K4)], peak=None)) is None


def test_k4_roofline_without_spans_counts_one_row(monkeypatch):
    """A program that records no spans: every launch at one row"""
    monkeypatch.setattr(program_spans, 'records', lambda: None)
    metric = reader('k4_roofline')
    assert metric.read(reading([(0, 20_000, -1, K4)])) == pytest.approx(
        100. * metric.least_seconds(1, PEAK) / 20e-6)
