"""The program's spans (`utils.timer.span`): off outside a profiler
session, nested and on the profiler's clock inside one, and the span
tree of the edit chain, the syntheses and a training step.

The last test needs an NVIDIA GPU and skips elsewhere; on the card,
with the kernels built:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trace.py

This file imports neither JAX nor the JAX package.
"""
import collections
import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import promonet_tpu_torch as port
from promonet_tpu_torch.train import core
from promonet_tpu_torch.utils import timer


@pytest.fixture(autouse=True)
def _clean_records():
    """Each test reads only its own records"""
    timer.reset()
    yield
    timer.reset()


@pytest.fixture
def no_synchronize(monkeypatch):
    """Fail any call of torch.cuda.synchronize"""
    def refuse(*args, **kwargs):
        raise AssertionError('a span synchronized')

    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)


def profiled(call, activities=(ProfilerActivity.CPU,)):
    """(call()'s result, the profiler) of a call under the profiler"""
    with profile(activities=list(activities)) as profiler:
        result = call()
    return result, profiler


def children(records):
    """{parent id: [names of its children, in order]}"""
    out = collections.defaultdict(list)
    for record in records:
        out[record.parent].append(record.name)
    return out


def only(records, name):
    found = [record for record in records if record.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_spans_are_off_outside_a_profiler_session(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('record_function entered')

    monkeypatch.setattr(timer.autograd_profiler, 'record_function', refuse)
    with timer.span('outer', frames=3):
        with timer.span('inner'):
            pass
    assert timer.spans() == []
    monkeypatch.undo()

    def on():
        with timer.span('outer', frames=3):
            with timer.span('inner'):
                pass

    profiled(on)
    assert [record.name for record in timer.spans()] == ['outer', 'inner']
    assert timer.spans()[0].counts == {'frames': 3}
    timer.reset()
    assert timer.spans() == []


def test_nesting_sets_the_parent():
    def nested():
        with timer.span('a'):
            with timer.span('b'):
                with timer.span('c'):
                    pass
            with timer.span('d'):
                pass
        with timer.span('e'):
            pass

    profiled(nested)
    records = {record.name: record for record in timer.spans()}
    assert records['a'].parent == 0 and records['e'].parent == 0
    assert records['b'].parent == records['a'].id
    assert records['c'].parent == records['b'].id
    assert records['d'].parent == records['a'].id
    assert len({record.id for record in records.values()}) == 5
    for record in records.values():
        assert record.start_ns <= record.end_ns
    assert records['a'].start_ns <= records['b'].start_ns <= \
        records['c'].end_ns <= records['b'].end_ns <= records['d'].start_ns


def test_a_span_leaves_on_an_exception():
    def raises():
        with timer.span('outer'):
            with timer.span('failing'):
                raise ValueError('inside')

    def after():
        with timer.span('after'):
            pass

    with pytest.raises(ValueError):
        profiled(raises)
    profiled(after)
    records = {record.name: record for record in timer.spans()}
    assert records['failing'].end_ns is not None
    assert records['after'].parent == 0


def test_profile_starts_from_no_records_and_the_newest_are_kept(
        tmp_path, monkeypatch):
    def spans(*names):
        for name in names:
            with timer.span(name):
                pass

    profiled(lambda: spans('before'))
    with timer.profile(tmp_path):
        spans('a', 'b')
    assert [record.name for record in timer.spans()] == ['a', 'b']
    assert list(tmp_path.glob('*.pt.trace.json'))
    monkeypatch.setattr(timer, '_records', collections.deque(maxlen=2))
    profiled(lambda: spans('c', 'd', 'e'))
    assert [record.name for record in timer.spans()] == ['d', 'e']
    assert timer.KEPT >= 2 ** 16


def test_the_smoke_counts_no_annotation_as_device_work():
    """`chip_smoke.device_events` keeps the card's kernels, copies and
    fills, not the device-side annotations of host ranges"""
    import chip_smoke
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device_type, annotation):
        return types.SimpleNamespace(
            name=name, device_type=device_type,
            is_user_annotation=annotation)

    events = [event('block_kernel', cuda, False),
              event('promonet.resblock', cuda, True),
              event('Memcpy HtoD', cuda, False),
              event('promonet.resblock', cpu, False)]
    assert [found.name for found in chip_smoke.device_events(
        torch, events)] == ['block_kernel', 'Memcpy HtoD']
    # The profiler's own events carry the flag the smoke reads
    _, profiler = profiled(lambda: torch.ones(3) + 1)
    assert all(isinstance(found.is_user_annotation, bool)
               for found in profiler.events())


def test_spans_lie_on_the_profilers_clock():
    """Each span lies within 1 ms of the profiler's own event of it"""
    def work():
        for index in range(5):
            with timer.span('outer', index=index):
                torch.ones(64).sum()
                with timer.span('inner'):
                    torch.ones(64).cumsum(0)

    _, profiler = profiled(work)
    events = collections.defaultdict(list)
    for event in profiler.profiler.kineto_results.events():
        if event.name().startswith('promonet.'):
            events[event.name()[len('promonet.'):]].append(event)
    records = collections.defaultdict(list)
    for record in timer.spans():
        records[record.name].append(record)
    assert set(events) == set(records) == {'outer', 'inner'}
    for name, found in records.items():
        assert len(found) == len(events[name]) == 5
        for record, event in zip(
                found, sorted(events[name], key=lambda e: e.start_ns())):
            assert abs(event.start_ns() - record.start_ns) < 1e6
            assert abs(event.end_ns() - record.end_ns) < 1e6
            assert record.start_ns <= event.start_ns()
            assert event.end_ns() <= record.end_ns


def tiny_models(config):
    return (port.models.init.seeded(port.preprocess.PitchCNN(), 1),
            port.models.init.seeded(port.preprocess.PPGEncoder(), 2),
            port.models.init.seeded(port.models.Generator(config), 3))


def speech(config, seconds):
    rate = config.SAMPLE_RATE
    t = np.arange(int(seconds * rate)) / rate
    pitch = 180. + 60. * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / rate
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def edit_chain(config, models, audio):
    pitch_model, ppg_model, generator = models
    features = port.preprocess.from_audio(
        audio, pitch_model, ppg_model, config=config, device='cpu')
    edited = port.edit.from_features(
        *features, pitch_shift_cents=200., time_stretch_ratio=1.25,
        loudness_scale_db=-3., config=config)
    return port.synthesize.from_features(
        *edited, generator=generator, speaker=2, device='cpu')


def test_the_edit_chain_gives_the_span_tree(no_synchronize):
    config = port.config.load().replace(HIFIGAN_UPSAMPLE_INITIAL_SIZE=16)
    models = tiny_models(config)
    audio = speech(config, 1.)
    expected = edit_chain(config, models, audio)
    assert timer.spans() == []
    output, _ = profiled(lambda: edit_chain(config, models, audio))
    np.testing.assert_array_equal(output, expected)

    records = timer.spans()
    roots = [record.name for record in records if record.parent == 0]
    assert roots == ['preprocess', 'edit', 'synthesize']
    tree = children(records)
    ids = {record.name: record.id for record in records
           if record.name != 'resblock'}
    assert tree[ids['preprocess']] == [
        'preprocess.loudness', 'preprocess.pitch', 'preprocess.ppg']
    assert tree[ids['preprocess.pitch']] == ['viterbi.decode']
    assert ids['edit'] not in tree
    assert tree[ids['synthesize']] == ['vocoder']
    assert tree[ids['vocoder']] == ['resblock'] * 12
    frames = audio.shape[-1] // config.HOPSIZE
    out_frames = int(round(frames / 1.25))
    bucket = port.data.bucket_frames(
        out_frames, config.INFERENCE_FRAME_BUCKETS)
    assert only(records, 'vocoder').counts == {
        'frames': bucket, 'true_frames': out_frames}
    for record in records:
        parent = next((other for other in records
                       if other.id == record.parent), None)
        if parent is not None:
            assert parent.start_ns <= record.start_ns <= record.end_ns <= \
                parent.end_ns


def test_frame_counts_of_fargan_and_batched_synthesis():
    config = port.config.load('configs/fargan.py')
    generator = port.models.init.seeded(port.models.Generator(config), 4)
    frames = 40
    rng = np.random.default_rng(0)
    features = (
        rng.uniform(-60, -20, (config.LOUDNESS_BANDS, frames)).astype(
            np.float32),
        rng.uniform(100, 200, (1, frames)).astype(np.float32),
        rng.random((1, frames)).astype(np.float32),
        np.full((config.PPG_CHANNELS, frames), 1. / config.PPG_CHANNELS,
                np.float32))
    profiled(lambda: port.synthesize.from_features(
        *features, generator=generator, device='cpu'))
    records = timer.spans()
    assert [record.name for record in records] == [
        'synthesize', 'vocoder', 'frame_loop']
    bucket = port.data.bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)
    assert records[1].counts == {'frames': bucket, 'true_frames': frames}
    assert records[1].parent == records[0].id
    # FARGAN's frame loop inside the vocoder: no subframe ran as K4 here
    assert records[2].counts == {
        'subframes': 4 * bucket, 'rows': 1, 'fused': 0}
    assert records[2].parent == records[1].id

    timer.reset()
    config = port.config.load().replace(HIFIGAN_UPSAMPLE_INITIAL_SIZE=16)
    generator = port.models.init.seeded(port.models.Generator(config), 5)
    lengths = [70, 100, 128, 90, 65]
    sets = [tuple(value[..., :1].repeat(length, -1) for value in (
        np.full((config.LOUDNESS_BANDS, 1), -40., np.float32),
        np.full((1, 1), 150., np.float32),
        np.full((1, 1), .5, np.float32),
        np.full((config.PPG_CHANNELS, 1), 1. / config.PPG_CHANNELS,
                np.float32))) for length in lengths]
    profiled(lambda: port.synthesize.from_features_batched(
        sets, generator, batch_size=4, device='cpu'))
    vocoders = [record for record in timer.spans()
                if record.name == 'vocoder']
    # Two calls of 4 rows at the 128-frame bucket: the second has one set,
    # repeated
    assert [record.counts for record in vocoders] == [
        {'frames': 4 * 128, 'true_frames': 70 + 100 + 128 + 90},
        {'frames': 4 * 128, 'true_frames': 65}]
    assert only(timer.spans(), 'synthesize').id == vocoders[0].parent


def test_a_training_step_gives_its_five_phases(no_synchronize):
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=16, CHUNK_SIZE=2048, BATCH_SIZE=2,
        PRECISION='float32')
    state = core.create_state(config, 'cpu')
    batch = core.to_device(core.example_batch(config, 2), 'cpu')
    profiled(lambda: core.train_step(state, batch))
    records = timer.spans()
    step = only(records, 'train.step')
    assert step.parent == 0
    # A CPU step runs eagerly, never by CUDA graphs
    assert step.counts == {'graphed': 0}
    phases = [record for record in records if record.parent == step.id]
    assert [record.name for record in phases] == [
        'train.generator', 'train.discriminator', 'train.losses',
        'train.backward', 'train.optimizer']
    for before, after in zip(phases, phases[1:]):
        assert before.end_ns <= after.start_ns
    for phase in phases:
        assert step.start_ns <= phase.start_ns <= phase.end_ns <= \
            step.end_ns
    # The generator's backbone is a span inside its phase
    vocoder = only(records, 'vocoder')
    assert vocoder.parent == phases[0].id
    assert vocoder.counts == {'frames': 2 * 2048 // config.HOPSIZE,
                              'true_frames': 2 * 2048 // config.HOPSIZE}


def runtime_launches(profiler):
    """[(kernel name, launch start_ns)] of the device kernels, each
    linked to the CUDA runtime call that launched it by the correlation id
    they share. An operator's event can carry the same number from a
    counter of its own, so only the runtime's launch calls are matched"""
    events = list(profiler.profiler.kineto_results.events())
    launches = {
        event.correlation_id(): event.start_ns() for event in events
        if event.device_type() == torch.autograd.DeviceType.CPU and
        event.name().startswith('cu') and 'Launch' in event.name()}
    return [(event.name(), launches.get(event.correlation_id()))
            for event in events
            if event.device_type() == torch.autograd.DeviceType.CUDA and
            not event.is_user_annotation()]


def launched_at_spans(profiler, reduced):
    """(the kernels of `trace.reduce` whose launch time is the start of a
    `promonet.*` range, those among them launched outside that range):
    a kernel launched inside a range with no operator around its launch
    call has the range for its operator, and any other is one whose
    correlation id the reduction matched to the range's by chance"""
    events = list(profiler.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    # The CUDA API's calls (cuda*, cu*): launches, copies, fills
    calls = {event.correlation_id(): event.start_ns() for event in events
             if event.device_type() == cpu and event.name().startswith('cu')}
    own = {(event.start_ns(), event.end_ns(), event.name()):
           calls.get(event.correlation_id()) for event in events
           if event.device_type() == torch.autograd.DeviceType.CUDA}
    ranges = collections.defaultdict(list)
    for event in events:
        if event.device_type() == cpu and \
                event.name().startswith('promonet.'):
            ranges[event.start_ns()].append(event.end_ns())
    at = [(start, end, launch, name) for start, end, launch, name
          in reduced.kernels if launch in ranges]
    outside = [kernel for kernel in at if not any(
        kernel[2] <= (own.get(kernel[:2] + kernel[3:]) or -1) <= end
        for end in ranges[kernel[2]])]
    return at, outside


@pytest.mark.cuda
def test_kernel_launches_lie_in_their_spans():
    """On the card: each K1 and K2 kernel launched inside the program's
    `resblock` and `viterbi.decode` spans has its launch call inside one
    of those spans; the benchmark's trace reduction keeps no `promonet.*`
    event as device work, and counts the same launches as the same
    window with the spans off, the same kernels in the same order; no
    kernel's launch time is the start of a span it was not launched in"""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from portbench import trace
    config = port.config.load()
    models = [model.cuda() for model in tiny_models(config)]
    audio = speech(config, 2.)

    def chain():
        pitch_model, ppg_model, generator = models
        features = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, config=config, device='cuda')
        edited = port.edit.from_features(
            *features, pitch_shift_cents=200., time_stretch_ratio=1.25,
            config=config)
        return port.synthesize.from_features(
            *edited, generator=generator, speaker=2, device='cuda')

    def window():
        with record_function(trace.PREFIX + 'window'):
            output = chain()
        torch.cuda.synchronize()
        return output

    expected = chain()
    activities = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    output, profiler = profiled(window, activities)
    np.testing.assert_array_equal(output, expected)
    reduced = trace.reduce(profiler)
    records = timer.spans()
    timer.reset()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(timer, 'span', lambda name, **counts: timer._OFF)
        _, profiler_off = profiled(window, activities)
    assert timer.spans() == []
    reduced_off = trace.reduce(profiler_off)

    assert not any(kernel[3].startswith('promonet.')
                   for kernel in reduced.kernels)
    assert reduced.launches() == reduced_off.launches() > 0
    # The same kernels in the same order, and none given the start of a
    # span's range that it was not launched in
    assert [kernel[3] for kernel in reduced.kernels] == \
        [kernel[3] for kernel in reduced_off.kernels]
    at, outside = launched_at_spans(profiler, reduced)
    print(f'kernels {len(reduced.kernels)}, {len(at)} at the start of a '
          f'span, {len(outside)} of them launched outside it')
    assert outside == []
    kernels = runtime_launches(profiler)
    for name, kernel_name, count in (('resblock', 'block_kernel', 12),
                                     ('viterbi.decode', 'viterbi_kernel', 1)):
        spans = [(record.start_ns, record.end_ns) for record in records
                 if record.name == name]
        launched = [launch for found, launch in kernels
                    if re.search(rf'\b{kernel_name}\b', found)]
        assert len(spans) == count and len(launched) >= count, name
        for launch in launched:
            assert launch is not None and any(
                start <= launch <= end for start, end in spans), (
                name, launch, spans)
