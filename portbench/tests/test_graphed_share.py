"""`graphed_share.train` on hand-made spans, and on a program that
records no `graphed` count (a trainer before its CUDA graphs)"""
import importlib.util

import pytest

import tiny
from portbench import program_spans, trace
from portbench.harness import Reading, Window
from promonet_tpu_torch.utils.timer import Record

WINDOW = (0, 10_000)


def reader():
    path = tiny.ROOT / 'portbench' / 'metrics' / 'graphed_share.train.py'
    spec = importlib.util.spec_from_file_location(
        'test_metric_graphed_share_train', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record(name, id, parent, start, end, **counts):
    span = Record(name, id, parent, start, counts)
    span.end_ns = end
    return span


def steps(*graphed):
    """One `train.step` span a value of `graphed` (None: no count), each
    with a phase inside it, 1,000 ns apart"""
    out = []
    for index, value in enumerate(graphed):
        counts = {} if value is None else {'graphed': value}
        start = 1_000 * index + 100
        out.append(record('train.step', 2 * index + 1, 0, start,
                          start + 800, **counts))
        out.append(record('train.generator', 2 * index + 2, 2 * index + 1,
                          start + 10, start + 200))
    return out


def reading():
    reduced = trace.Trace([], {'window': [WINDOW]}, WINDOW)
    return Reading(reduced, {}, Window(4, 0, 1e-5, {}), None, None, {})


@pytest.mark.parametrize('graphed, share', [
    ((1, 1, 1, 1), 100.),
    ((0, 1, 1, 1), 75.),
    ((0, 0, 0, 0), 0.),
], ids=['all-replayed', 'one-eager', 'all-eager'])
def test_graphed_share_counts_the_replayed_steps(
        monkeypatch, graphed, share):
    monkeypatch.setattr(program_spans, 'records', lambda: steps(*graphed))
    assert reader().read(reading()) == pytest.approx(share)


def test_steps_outside_the_window_are_not_read(monkeypatch):
    spans = steps(1, 1) + [
        record('train.step', 99, 0, 20_000, 30_000, graphed=0)]
    monkeypatch.setattr(program_spans, 'records', lambda: spans)
    assert reader().read(reading()) == pytest.approx(100.)


@pytest.mark.parametrize('spans', [None, [], steps(None, None)],
                         ids=['no-spans', 'none-kept', 'no-count'])
def test_graphed_share_reads_nothing_without_a_count(monkeypatch, spans):
    monkeypatch.setattr(program_spans, 'records', lambda: spans)
    assert reader().read(reading()) is None
