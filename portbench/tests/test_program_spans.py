"""The program's spans laid against a device trace (`program_spans`), on
hand-made traces and spans, against a count nanosecond by nanosecond"""
import collections
import json

import pytest

import tiny  # noqa: F401  (puts the checkout on the path)
from portbench import program_spans, trace
from portbench.harness import Reading, Window
from promonet_tpu_torch.utils.timer import Record


def record(name, id, parent, start, end, **counts):
    span = Record(name, id, parent, start, counts)
    span.end_ns = end
    return span


WINDOW = (0, 1000)
KERNELS = [(100, 200, 90, 'a'), (150, 300, 95, 'b'), (500, 600, 480, 'c'),
           (900, 1100, 880, 'd'), (-50, 5, -60, 'before')]
INFER = [
    record('preprocess', 1, 0, 50, 700),
    record('preprocess.pitch', 2, 1, 120, 450),
    record('viterbi.decode', 3, 2, 350, 420),
    record('preprocess.loudness', 4, 1, 460, 520),
    record('edit', 5, 0, 700, 760),
    record('synthesize', 6, 0, 760, 990),
    record('vocoder', 7, 6, 800, 950, frames=40, true_frames=30),
    record('resblock', 8, 7, 810, 820),
    record('vocoder', 9, 6, 955, 985, frames=40, true_frames=40),
    # A span of another window is not read
    record('preprocess', 10, 0, 2000, 3000),
]
TRAIN = [
    record('train.step', 1, 0, 10, 990),
    record('train.generator', 2, 1, 20, 300),
    record('vocoder', 3, 2, 40, 250, frames=8, true_frames=8),
    record('train.discriminator', 4, 1, 300, 500),
    record('train.losses', 5, 1, 500, 700),
    record('train.backward', 6, 1, 700, 900),
    record('train.optimizer', 7, 1, 900, 980),
]

# The families the metrics' readers declare in BENCHMARK.json's order
INFER_FAMILY = {
    'idle_ms.preprocess': ('preprocess',),
    'idle_ms.loudness': ('preprocess.loudness',),
    'idle_ms.pitch': ('preprocess.pitch', 'viterbi.decode'),
    'idle_ms.ppg': ('preprocess.ppg',),
    'idle_ms.synthesize': ('synthesize',),
    'idle_ms.vocoder': ('vocoder', 'resblock'),
    'idle_ms.edit': ('edit',),
}
TRAIN_FAMILY = {
    'idle_ms.generator': ('train.generator',),
    'idle_ms.discriminator': ('train.discriminator',),
    'idle_ms.losses': ('train.losses',),
    'idle_ms.backward': ('train.backward',),
    'idle_ms.optimizer': ('train.optimizer',),
    'idle_ms.step': ('train.step',),
}


def idle_by_nanosecond(kernels, spans, window):
    """{span id or 0: idle ns}, one nanosecond at a time"""
    out = collections.Counter()
    for moment in range(*window):
        if any(start <= moment < end for start, end, _, _ in kernels):
            continue
        open_spans = [span for span in spans
                      if span.start_ns <= moment < span.end_ns]
        owner = max(open_spans, key=lambda span: (span.start_ns, span.id),
                    default=None)
        out[owner.id if owner else 0] += 1
    return out


@pytest.mark.parametrize('spans', [INFER, TRAIN], ids=['infer', 'train'])
def test_idle_pieces_partition_the_idle_window(spans):
    reduced = trace.Trace(KERNELS, {'window': [WINDOW]}, WINDOW)
    inside = program_spans.in_window(spans, WINDOW)
    idle = program_spans.idle_by_span(reduced, inside)
    expected = idle_by_nanosecond(KERNELS, inside, WINDOW)
    assert {owner: round(seconds * 1e9) for owner, seconds in idle.items()
            if seconds} == dict(expected)
    window_idle = reduced.window_s - reduced.busy_s()
    assert sum(idle.values()) == pytest.approx(window_idle, rel=1e-12)
    assert window_idle == pytest.approx(595e-9)


def test_the_metrics_of_a_layer_sum_to_its_root_spans():
    reduced = trace.Trace(KERNELS, {'window': [WINDOW]}, WINDOW)
    spans = program_spans.in_window(INFER, WINDOW)
    idle = program_spans.by_metric(
        program_spans.idle_by_span(reduced, spans), spans, INFER_FAMILY)
    by_ns = idle_by_nanosecond(KERNELS, [], WINDOW)[0]
    assert sum(idle.values()) == pytest.approx(by_ns / 1e9, rel=1e-12)

    def idle_inside(name):
        return sum(
            1 for moment in range(*WINDOW)
            if not any(start <= moment < end for start, end, _, _ in KERNELS)
            and any(span.name == name and span.start_ns <= moment <
                    span.end_ns for span in spans)) / 1e9

    preprocess = ('idle_ms.preprocess', 'idle_ms.loudness', 'idle_ms.pitch',
                  'idle_ms.ppg')
    assert sum(idle.get(name, 0.) for name in preprocess) == \
        pytest.approx(idle_inside('preprocess'), rel=1e-12)
    assert idle['idle_ms.synthesize'] + idle['idle_ms.vocoder'] == \
        pytest.approx(idle_inside('synthesize'), rel=1e-12)
    assert idle['idle_ms.edit'] == pytest.approx(
        idle_inside('edit'), rel=1e-12)
    # The decode's idle is the pitch metric's, the K1 span's the vocoder's
    assert idle['idle_ms.pitch'] == pytest.approx(
        idle_inside('preprocess.pitch'), rel=1e-12)
    assert idle['idle_ms.vocoder'] == pytest.approx(
        idle_inside('vocoder'), rel=1e-12)
    assert idle[program_spans.OUTSIDE] == pytest.approx(
        by_ns / 1e9 - idle_inside('preprocess') - idle_inside('edit') -
        idle_inside('synthesize'), rel=1e-12)


def test_a_span_no_metric_of_the_family_names_goes_to_its_ancestor():
    reduced = trace.Trace(KERNELS, {'window': [WINDOW]}, WINDOW)
    idle = program_spans.by_metric(
        program_spans.idle_by_span(reduced, TRAIN), TRAIN, TRAIN_FAMILY)
    assert 'idle_ms.vocoder' not in idle
    assert sum(idle.values()) == pytest.approx(595e-9)
    # A span no metric names is kept apart, under its root's name
    spans = [record('train.step', 1, 0, 10, 990),
             record('train.custom', 2, 1, 20, 90)]
    unnamed = program_spans.by_metric(
        program_spans.idle_by_span(reduced, spans), spans, INFER_FAMILY)
    assert set(unnamed) == {'unnamed:train.step', program_spans.OUTSIDE}
    assert unnamed['unnamed:train.step'] == pytest.approx(590e-9)
    assert unnamed[program_spans.OUTSIDE] == pytest.approx(5e-9)
    # The generator's phase and the vocoder inside it are idle in [20, 100)
    assert idle['idle_ms.generator'] == pytest.approx(80e-9)
    # train.step outside its phases is idle in [10, 20), no span in [5, 10)
    assert idle['idle_ms.step'] == pytest.approx(10e-9)
    assert idle[program_spans.OUTSIDE] == pytest.approx(5e-9)


def test_the_readers(monkeypatch):
    reduced = trace.Trace(KERNELS, {'window': [WINDOW]}, WINDOW)
    reading = Reading(reduced, {}, Window(2, 0, 1e-6, {}), None, None, {})
    monkeypatch.setattr(program_spans, 'records', lambda: list(INFER))
    spans = program_spans.in_window(INFER, WINDOW)
    idle = program_spans.idle_by_span(reduced, spans)
    assert program_spans.idle_ms(reading, 'idle_ms.edit') == pytest.approx(
        1e3 * idle[5] / 2)
    assert program_spans.idle_ms(reading, 'idle_ms.vocoder') == \
        pytest.approx(1e3 * (idle.get(7, 0.) + idle.get(8, 0.) +
                             idle.get(9, 0.)) / 2)
    assert program_spans.wall_ms(reading, 'edit') == pytest.approx(
        60e-6 / 2)
    assert program_spans.padded_share(reading, 'vocoder') == \
        pytest.approx(100. * (1 - 70 / 80))
    # No span of the metric: no reading; no spans at all: none either
    assert program_spans.idle_ms(reading, 'idle_ms.ppg') is None
    assert program_spans.idle_ms(reading, 'idle_ms.losses') is None
    monkeypatch.setattr(program_spans, 'records', lambda: None)
    fresh = Reading(reduced, {}, Window(2, 0, 1e-6, {}), None, None, {})
    assert program_spans.idle_ms(fresh, 'idle_ms.edit') is None
    assert program_spans.wall_ms(fresh, 'edit') is None
    assert program_spans.padded_share(fresh, 'vocoder') is None


@pytest.mark.parametrize('metric, expected', [
    ('idle_ms.pitch', INFER_FAMILY), ('idle_ms.vocoder', INFER_FAMILY),
    ('idle_ms.step', TRAIN_FAMILY)], ids=['pitch', 'vocoder', 'step'])
def test_a_family_is_read_from_the_metrics_files(metric, expected):
    assert program_spans.family(metric) == expected


def test_a_new_idle_metric_joins_its_family(tmp_path):
    """A metric file with SPANS and a BENCHMARK.json entry joins the
    family of what it moves and takes its span out of its ancestor's
    reading; a span named by two metrics of a family is refused"""
    base = tmp_path / 'portbench'
    (base / 'metrics').mkdir(parents=True)
    entries = []
    for name, spans in [*INFER_FAMILY.items(),
                        ('idle_ms.decode', ('viterbi.decode',))]:
        if name == 'idle_ms.pitch':
            spans = ('preprocess.pitch',)
        (base / 'metrics' / f'{name}.py').write_text(f'SPANS = {spans!r}\n')
        entries.append({'name': name, 'moves': 'audio_s_per_s'})
    # A metric of another end-to-end metric, and one without spans
    (base / 'metrics' / 'idle_ms.step.py').write_text("SPANS = ('x',)\n")
    (base / 'metrics' / 'edit_ms.py').write_text('')
    entries += [{'name': 'idle_ms.step', 'moves': 'train_step_ms'},
                {'name': 'edit_ms', 'moves': 'audio_s_per_s'}]
    benchmark = tmp_path / 'BENCHMARK.json'
    benchmark.write_text(json.dumps({'per_layer': entries}))
    names = program_spans.family('idle_ms.decode', base)
    assert set(names) == set(INFER_FAMILY) | {'idle_ms.decode'}
    reduced = trace.Trace(KERNELS, {'window': [WINDOW]}, WINDOW)
    spans = program_spans.in_window(INFER, WINDOW)
    idle = program_spans.idle_by_span(reduced, spans)
    split = program_spans.by_metric(idle, spans, names)
    before = program_spans.by_metric(idle, spans, INFER_FAMILY)
    assert split['idle_ms.decode'] == pytest.approx(idle[3])
    assert split['idle_ms.pitch'] + split['idle_ms.decode'] == \
        pytest.approx(before['idle_ms.pitch'])
    (base / 'metrics' / 'idle_ms.pitch.py').write_text(
        "SPANS = ('preprocess.pitch', 'viterbi.decode')\n")
    with pytest.raises(ValueError, match='viterbi.decode'):
        program_spans.family('idle_ms.decode', base)
