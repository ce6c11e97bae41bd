"""Cells found by name from files alone, run on the CPU at a tiny width

The program's runs come out correct. The control (the reference in
float8 in the program's place) comes out not correct, and so does a run
with each fault its cell can have: an answer altered where it is
produced, half of a batch left out, a training step that leaves its
state unchanged.
"""
import copy
import json
import math

import numpy as np
import pytest
import torch

import tiny
from portbench import harness
from portbench.calibrate import planted
from portbench.drivers import batch as batch_driver
from portbench.drivers import edit as edit_driver

RESULT_KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}

SHORT = {'law': 'lognormal', 'median': 0.8, 'sigma': 0.6, 'low': 0.5,
         'high': 1.2}
SPEAKER = {'law': 'integers', 'count': 'NUM_SPEAKERS'}

# The tiny cells' mixes and limits; each limit lies between what the
# program and the control read at these sizes
EDIT = {'requests': 3, 'checked': 3,
        'bank': {'utterances': 1, 'seconds': 2.5}, 'laws': {'seconds': SHORT}}
EDIT_LIMITS = {'loudness_db': 1e-3, 'pitch_path_nats': 1e-3,
               'pitch_cents': 0.05,
               'periodicity': 1e-4, 'ppg': 1e-4, 'edit': 1e-5}
AUDIO_LIMITS = {'hifigan': {'audio': 0.06},
                'fargan': {'audio': 0.02, 'conditioning': 0.02,
                           'history': 0., 'states': 0.02}}
# FARGAN's cell compares no path gap (PERF.md)
NOT_COMPARED = {'fargan': {'pitch_path_nats'}, 'hifigan': set()}
BATCH = {'requests': 2, 'checked': 2, 'batch': 4,
         'laws': {'seconds': SHORT, 'speaker': SPEAKER}}
TRAIN = {'batch': 2, 'chunk': 4096, 'batches': 4, 'warmup_steps': 0}
TRAIN_LIMITS = {'loss': 1e-4, 'output': 1e-4, 'gradient': 1e-3,
                'change': 1e-3, 'loss.window': 1e-4, 'output.window': 1e-4,
                'gradient.median.window': 1e-3, 'change.window': 1e-3}
# bf16 training on the CPU is not what the card runs (this PyTorch's
# CPU transposed convolution returns a wrong input gradient in bf16)
FLOAT32 = "PRECISION = 'float32'\n"


def edit_limits(model):
    return {name: limit for name, limit in {
        **EDIT_LIMITS, **AUDIO_LIMITS[model]}.items()
        if name not in NOT_COMPARED[model]}


def edit_cell(tmp_path, model='hifigan'):
    return tiny.root(tmp_path, 'edit.single', edit_limits(model), model,
        overrides={**EDIT, 'laws': {
            **json.loads((tiny.ROOT / 'portbench' / 'traffic' /
                          'edit.single.json').read_text())['laws'],
            'seconds': SHORT}})


def batch_cell(tmp_path):
    return tiny.root(tmp_path, 'synth.batch8', {'audio': 0.02},
                     overrides=BATCH)


def train_cell(tmp_path):
    return tiny.root(tmp_path, 'train.b64', TRAIN_LIMITS, settings=FLOAT32,
                     overrides=TRAIN)


@pytest.mark.parametrize('model', ['hifigan', 'fargan'])
def test_edit_cell_found_by_name_runs_correct(tmp_path, capsys, model):
    result, checks = tiny.run(edit_cell(tmp_path, model), tmp_path)
    assert result['correct'], checks
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert set(result['metrics']) == {
        'audio_s_per_s', 'request_p95_ms', 'setup_s'}
    assert {check.name for check in checks} == set(edit_limits(model))
    harness.emit(result, checks)
    lines = capsys.readouterr()
    line = json.loads(lines.out.strip().splitlines()[-1])
    assert RESULT_KEYS <= set(line) and list(line)[-1] == 'checks'
    assert set(line['device']) >= {
        'platform', 'kind', 'count', 'memory_peak_bytes'}
    for metric in line['metrics'].values():
        assert set(metric) == {'value', 'unit'}
        assert math.isfinite(metric['value'])
    assert lines.err.strip().splitlines()[-1].startswith('check ')


def test_batch_cell_runs_correct(tmp_path):
    result, checks = tiny.run(batch_cell(tmp_path), tmp_path)
    assert result['correct'], checks
    assert [check.name for check in checks] == ['audio']


def test_train_cell_runs_correct(tmp_path):
    result, checks = tiny.run(train_cell(tmp_path), tmp_path)
    assert result['correct'], checks
    assert set(result['metrics']) == {'train_step_ms', 'setup_s'}


@pytest.mark.parametrize('cell', ['edit-hifigan', 'edit-fargan', 'batch',
                                  'train'])
def test_control_is_not_correct(tmp_path, cell):
    benchmark = {
        'edit-hifigan': lambda: edit_cell(tmp_path),
        'edit-fargan': lambda: edit_cell(tmp_path, 'fargan'),
        'batch': lambda: batch_cell(tmp_path),
        'train': lambda: train_cell(tmp_path)}[cell]()
    result, checks = tiny.run(benchmark, tmp_path, system='control')
    assert not result['correct']
    assert any(not check.passed for check in checks)


@pytest.mark.parametrize('fault', ['audio', 'loudness', 'pitch', 'edited'])
def test_altered_answer_is_not_correct(tmp_path, monkeypatch, fault):
    """An answer altered where it is produced: the synthesized audio, a
    preprocessed feature, or an edited one"""
    serve = edit_driver.Program.serve

    def altered(self, request):
        served = serve(self, request)
        if fault == 'audio':
            served.audio = served.audio.copy()
            served.audio[..., ::7] += 0.05
        elif fault == 'loudness':
            loudness, *rest = served.features
            served.features = (loudness + 0.5, *rest)
        elif fault == 'pitch':
            loudness, pitch, *rest = served.features
            served.features = (loudness, torch.roll(pitch, 3, -1), *rest)
        else:
            *rest, ppg = served.edited
            served.edited = (*rest, torch.roll(ppg, 1, -2))
        return served

    monkeypatch.setattr(edit_driver.Program, 'serve', altered)
    result, _ = tiny.run(edit_cell(tmp_path), tmp_path)
    assert not result['correct']


@pytest.mark.parametrize('fault', ['offset', 'stale'])
def test_frame_loop_fault_is_not_correct(tmp_path, monkeypatch, fault):
    """FARGAN's frame loop with a fault in what it carries between
    subframes, while every subframe computes right from what it is fed:
    a lookback gathered a sample off, or the recurrent states carried
    stale"""
    from promonet_tpu_torch.models import fargan
    if fault == 'offset':
        index = fargan.lookback_index
        monkeypatch.setattr(fargan, 'lookback_index', lambda *args: (
            index(*args) - 1).clamp(min=0))
    else:
        forward = fargan.SubframeNetwork.forward

        def faulty(self, features, lookback, previous, states, *args):
            output, _ = forward(
                self, features, lookback, previous, states, *args)
            return output, states

        monkeypatch.setattr(fargan.SubframeNetwork, 'forward', faulty)
    result, checks = tiny.run(edit_cell(tmp_path, 'fargan'), tmp_path)
    assert not result['correct']
    failed = {check.name for check in checks if not check.passed}
    assert failed & {'history', 'states'}, checks


def test_batch_half_left_out_is_not_correct(tmp_path, monkeypatch):
    """Half of each batch left out: its rows answered by the other half"""
    import promonet_tpu_torch as port
    batched = port.synthesize.from_features_batched

    def half(feature_sets, *args, **kwargs):
        audio = batched(feature_sets, *args, **kwargs)
        kept = audio.shape[0] // 2
        return torch.cat((audio[:kept], audio[:audio.shape[0] - kept]))

    monkeypatch.setattr(port.synthesize, 'from_features_batched', half)
    result, _ = tiny.run(batch_cell(tmp_path), tmp_path)
    assert not result['correct']


@pytest.mark.parametrize('fault', ['unchanged', 'half'])
def test_train_fault_is_not_correct(tmp_path, fault):
    """A step that returns its state unchanged, or one that leaves half
    of the batch out and takes the mean over the rest"""
    with planted(fault):
        result, _ = tiny.run(train_cell(tmp_path), tmp_path)
    assert not result['correct']


def test_missing_cell_exits_nonzero(tmp_path):
    """A cell the folder does not define cannot run"""
    (tmp_path / 'BENCHMARK.json').write_text(
        (tiny.ROOT / 'BENCHMARK.json').read_text())
    code = harness.main(
        ['--workload', 'nonesuch', '--seed', '1', '--seconds', '1'],
        0., tmp_path)
    assert code != 0


def test_same_seed_same_requests():
    import promonet_tpu_torch as port
    config = port.config.load()
    traffic = copy.deepcopy(json.loads(
        (tiny.ROOT / 'portbench' / 'traffic' / 'edit.single.json').read_text()))
    traffic.update(requests=4, bank={'utterances': 1, 'seconds': 3.0})
    traffic['laws']['seconds'].update(high=2.0)
    first = edit_driver.requests(traffic, 2 ** 31 + 5, config)
    second = edit_driver.requests(traffic, 2 ** 31 + 5, config)
    other = edit_driver.requests(traffic, 11, config)
    for a, b in zip(first, second):
        assert np.array_equal(a.audio, b.audio)
        assert (a.pitch_shift_cents, a.speaker) == (
            b.pitch_shift_cents, b.speaker)
    assert sorted(a.audio.shape[-1] for a in first) == sorted(
        a.audio.shape[-1] for a in other)
    device = torch.device('cpu')
    sets = batch_driver.requests(BATCH, 3, config, device)
    again = batch_driver.requests(BATCH, 3, config, device)
    for a, b in zip(sets, again):
        assert a.frames == b.frames and a.speakers == b.speakers
        assert all(torch.equal(x, y) for set_a, set_b in zip(a.sets, b.sets)
                   for x, y in zip(set_a, set_b))
