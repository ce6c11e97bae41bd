"""Port's Viterbi decode held against the JAX package's, path for path.

The plain PyTorch version (the CPU path) only adds and compares, as the
JAX scan and the Pallas kernel do, so the decoded paths must be equal
exactly, ties included (first index wins).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from promonet_tpu.ops import viterbi as jax_viterbi
from promonet_tpu_torch.ops import viterbi


def _problem(seed, frames, states, width=9.):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((frames, states)) * 3
    observation = np.array(
        jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), axis=-1))
    transition = np.array(
        jax_viterbi.triangular_transition(states, min(width, states)))
    initial = np.full(states, -np.log(np.float32(states)), np.float32)
    return observation, transition, initial


def _ours(observation, transition, initial):
    return viterbi.decode(
        torch.from_numpy(observation), torch.from_numpy(transition),
        torch.from_numpy(initial)).numpy()


@pytest.mark.parametrize('states', [8, 256])
@pytest.mark.parametrize('frames', [1, 2, 37, 128])
def test_plain_decode_matches_jax_scan(frames, states):
    problem = _problem(frames * 1000 + states, frames, states)
    theirs = np.asarray(jax_viterbi.decode(
        *map(jnp.asarray, problem), use_pallas=False))
    ours = _ours(*problem)
    assert ours.dtype == np.int32 and ours.shape == (frames,)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('states', [8, 256])
@pytest.mark.parametrize('frames', [2, 37, 128])
def test_plain_decode_matches_pallas_kernel(frames, states):
    problem = _problem(frames + states, frames, states)
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(jax_viterbi.decode(
            *map(jnp.asarray, problem), use_pallas=True))
    np.testing.assert_array_equal(_ours(*problem), theirs)


@pytest.mark.parametrize('states', [8, 256])
def test_ties_break_to_the_first_index(states):
    """Quantized observations: many exactly tied scores every frame"""
    rng = np.random.default_rng(7)
    observation = np.round(rng.standard_normal((40, states))).astype(
        np.float32)
    observation[10:20] = 0.
    transition = np.zeros((states, states), np.float32)
    initial = np.zeros(states, np.float32)
    theirs = np.asarray(jax_viterbi.decode(
        jnp.asarray(observation), jnp.asarray(transition),
        jnp.asarray(initial), use_pallas=False))
    np.testing.assert_array_equal(
        _ours(observation, transition, initial), theirs)
    # All-tied input decodes to state 0 everywhere
    flat = np.zeros((5, states), np.float32)
    np.testing.assert_array_equal(_ours(flat, transition, initial), 0)


def test_plain_decode_matches_brute_force():
    observation, transition, initial = _problem(3, 6, 4, width=2.)
    best, best_score = None, -np.inf
    for candidate in itertools.product(range(4), repeat=6):
        score = initial[candidate[0]] + observation[0][candidate[0]]
        for t in range(1, 6):
            score += transition[candidate[t - 1], candidate[t]] + \
                observation[t][candidate[t]]
        if score > best_score:
            best, best_score = candidate, score
    np.testing.assert_array_equal(
        _ours(observation, transition, initial), best)


def test_triangular_transition_matches_jax():
    np.testing.assert_array_equal(
        viterbi.triangular_transition(256, 9.).numpy(),
        np.asarray(jax_viterbi.triangular_transition(256, 9.)))


def test_decode_counts_no_launch_on_cpu():
    before = viterbi.decode.launches
    _ours(*_problem(0, 5, 8))
    assert viterbi.decode.launches == before


###############################################################################
# The band form and the CUDA kernel's algorithm, emulated in numpy
###############################################################################


def _transitions():
    rng = np.random.default_rng(11)
    return {
        'triangular': viterbi.triangular_transition(256, 9.).numpy(),
        'all_equal': np.full((24, 24), -3.25, np.float32),
        'random': rng.standard_normal((24, 24)).astype(np.float32),
        'logfreq': viterbi.logfreq_transition_dense(
            np.linspace(50., 8000., 200)).numpy()}


@pytest.mark.parametrize(
    'name', ['triangular', 'all_equal', 'random', 'logfreq'])
def test_band_form_reproduces_the_matrix(name):
    dense = _transitions()[name]
    values, offsets, lows, floor, has_floor = viterbi.band_form(
        torch.from_numpy(dense))
    assert values.dtype == np.float32 and offsets.dtype == np.int32
    np.testing.assert_array_equal(
        viterbi.band_dense(values, offsets, lows, floor), dense)
    assert floor == dense.min()
    assert has_floor == (len(values) < dense.size)
    if name == 'triangular':
        # 17 sources per destination, fewer at the edges
        assert np.diff(offsets).max() == 17 and has_floor
    if name == 'all_equal':
        assert len(values) == 0


def _better(a, b):
    """The kernel's order: NaN is the maximum, then value, then index"""
    a_nan, b_nan = np.isnan(a[0]), np.isnan(b[0])
    if a_nan or b_nan:
        return a_nan and (not b_nan or a[1] < b[1])
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _first_best(values):
    best = (np.float32(-np.inf), np.iinfo(np.int32).max)
    for index, value in enumerate(values):
        if _better((value, index), best):
            best = (value, index)
    return best


def _emulate_kernel(observation, transition, initial, chunk_rows=7):
    """`csrc/viterbi.cu` step by step in float32 numpy

    Run scan opened by the run's first source and advanced on a strict
    `>` (a NaN enters once), the floor candidate as the first best of the
    sums alpha + floor, the better of the two per destination, and the
    backtrace over chunks of `chunk_rows` predecessor rows.
    """
    values, offsets, lows, floor, has_floor = viterbi.band_form(transition)
    frames, states = observation.shape
    predecessors = np.zeros((frames, states), np.int32)
    alpha = (initial + observation[0]).astype(np.float32)
    with np.errstate(invalid='ignore'):
        for t in range(1, frames):
            floor_best = _first_best(alpha + floor) if has_floor else None
            current = np.empty_like(alpha)
            for j in range(states):
                low, begin = lows[j], offsets[j]
                length = offsets[j + 1] - begin
                own = (np.float32(-np.inf), np.iinfo(np.int32).max)
                if length > 0:
                    own = (alpha[low] + values[begin], low)
                    for r in range(1, length):
                        score = alpha[low + r] + values[begin + r]
                        if score > own[0] or (
                                np.isnan(score) and not np.isnan(own[0])):
                            own = (score, low + r)
                if has_floor and _better(floor_best, own):
                    own = floor_best
                predecessors[t, j] = own[1]
                current[j] = own[0] + observation[t, j]
            alpha = current
    state = _first_best(alpha)[1]
    path = np.empty(frames, np.int32)
    path[-1] = state
    hi = frames - 1
    while hi >= 1:
        lo = max(1, hi - chunk_rows + 1)
        chunk = predecessors[lo:hi + 1].copy()
        for t in range(hi, lo - 1, -1):
            state = chunk[t - lo, state]
            path[t - 1] = state
        hi = lo - 1
    return predecessors, alpha, path


def _kernel_problem(kind):
    rng = np.random.default_rng(len(kind))
    states, frames = 24, 19
    transition = np.array(viterbi.triangular_transition(states, 4.))
    observation = np.array(jax.nn.log_softmax(jnp.asarray(
        3 * rng.standard_normal((frames, states)), jnp.float32), axis=-1))
    if kind == 'ties':
        observation = np.round(
            rng.standard_normal((frames, states))).astype(np.float32)
        transition = np.where(transition > -1e29, 0., transition).astype(
            np.float32)
    elif kind == 'masked':
        observation[rng.random((frames, states)) < 0.6] = -np.inf
        observation[5] = -np.inf
    elif kind == 'nan':
        observation[frames // 2] = np.nan
    elif kind == 'one_frame':
        observation = observation[:1]
    elif kind == 'no_floor':
        transition = rng.standard_normal((states, states)).astype(np.float32)
    elif kind == 'all_equal':
        transition = np.zeros((states, states), np.float32)
        observation = np.round(observation)
    initial = np.full(states, -np.log(np.float32(states)), np.float32)
    return observation, transition, initial


@pytest.mark.parametrize('kind', [
    'random', 'ties', 'masked', 'nan', 'one_frame', 'no_floor', 'all_equal'])
def test_kernel_algorithm_matches_plain_scan(kind):
    observation, transition, initial = _kernel_problem(kind)
    indices, final_alpha = viterbi.forward_plain(
        *map(torch.from_numpy, (observation, transition, initial)))
    predecessors, alpha, path = _emulate_kernel(
        observation, transition, initial)
    np.testing.assert_array_equal(predecessors, indices.numpy())
    np.testing.assert_array_equal(alpha, final_alpha.numpy())
    np.testing.assert_array_equal(
        path, viterbi.backtrace_plain(indices, final_alpha).numpy())


def test_kernel_algorithm_matches_jax_decode():
    observation, transition, initial = _kernel_problem('random')
    theirs = np.asarray(jax_viterbi.decode(
        *map(jnp.asarray, (observation, transition, initial)),
        use_pallas=False))
    np.testing.assert_array_equal(
        _emulate_kernel(observation, transition, initial)[2], theirs)


def test_decode_takes_a_batch_and_a_band_on_cpu():
    observation, transition, initial = map(
        torch.from_numpy, _kernel_problem('random'))
    single = viterbi.decode(observation, transition, initial)
    batch = torch.stack([observation, observation.flip(0)])
    paths = viterbi.decode(batch, transition, initial)
    assert paths.shape == (2, observation.shape[0])
    np.testing.assert_array_equal(paths[0].numpy(), single.numpy())
    np.testing.assert_array_equal(
        paths[1].numpy(),
        viterbi.decode(observation.flip(0), transition, initial).numpy())
    np.testing.assert_array_equal(
        viterbi.decode(observation, viterbi.banded(transition),
                       initial).numpy(), single.numpy())


def test_banded_is_cached_until_the_tensor_changes():
    transition = viterbi.triangular_transition(16, 3.)
    band = viterbi.banded(transition)
    assert viterbi.banded(transition) is band
    assert viterbi.banded(band) is band
    transition[0, 0] = -0.5
    again = viterbi.banded(transition)
    assert again is not band
    np.testing.assert_array_equal(
        viterbi.band_dense(
            again.values.numpy(), again.offsets.numpy(), again.lows.numpy(),
            np.float32(again.floor)), transition.numpy())


@pytest.mark.parametrize('states,entries,frames,entry_bytes', [
    (256, 4280, 896, 1), (256, 4280, 4096, 1), (256, 65536, 896, 1),
    (2039, 753917, 861, 2), (24, 0, 1, 1)])
def test_decode_plan_fits_shared_memory(states, entries, frames, entry_bytes):
    plan = viterbi.decode_plan(states, entries, frames, entry_bytes)
    forward = 4 * ((2 + viterbi.DECODE_RING) * states + 2 * states + 1 +
                   plan['table_in_shared'])
    assert plan['table_in_shared'] in (0, entries)
    assert forward <= plan['shared_bytes'] <= viterbi.DECODE_SHARED_LIMIT
    assert plan['shared_bytes'] >= states * entry_bytes
    assert plan['shared_bytes'] % 16 == 0


###############################################################################
# The cluster route of the log-frequency decode: its plan, and its
# algorithm emulated in numpy
###############################################################################


STFT_AXIS = np.abs(np.fft.fftfreq(4096, 1 / 22050)[:2049])
STFT_AXIS = STFT_AXIS[int(np.searchsorted(STFT_AXIS, 50.)):].astype(
    np.float32)
SMALL_AXIS = np.linspace(50., 8000., 200)
INT_MAX = np.iinfo(np.int32).max


def _plan(axis, blocks, threads=None):
    values, offsets, lows, floor = viterbi.band_table(axis)
    return viterbi.cluster_plan(
        values, offsets, lows, floor, blocks, threads), floor


@pytest.mark.parametrize('states', [1, 5, 31, 200])
def test_group_rows_are_the_union_of_the_runs(states):
    axis = np.linspace(50., 8000., states)
    _, offsets, lows, _ = viterbi.band_table(axis)
    first, rows = viterbi.group_rows(offsets, lows)
    assert len(first) == -(-states // viterbi.GROUP)
    for g in range(len(first)):
        members = range(
            g * viterbi.GROUP, min((g + 1) * viterbi.GROUP, states))
        assert first[g] == min(lows[j] for j in members)
        assert first[g] + rows[g] == max(
            lows[j] + offsets[j + 1] - offsets[j] for j in members)


@pytest.mark.parametrize('axis,blocks', [
    ('small', 1), ('small', 2), ('small', 4), ('small', 16), ('tiny', 8),
    ('stft', 16)])
def test_cluster_plan_covers_every_destination_once(axis, blocks):
    axis = {'small': SMALL_AXIS, 'tiny': np.linspace(50., 8000., 31),
            'stft': STFT_AXIS}[axis]
    plan, _ = _plan(axis, blocks)
    info = plan['block_info']
    # Contiguous ranges of destinations, in order, that cover the axis
    assert info[0, 0] == 0
    np.testing.assert_array_equal(info[1:, 0], (info[:, 0] + info[:, 1])[:-1])
    assert info[:, 1].sum() == len(axis)
    assert plan['threads'] % 32 == 0
    assert plan['threads'] <= viterbi.CLUSTER_THREADS
    for block in range(blocks):
        _, destinations, lanes, groups = info[block]
        meta = plan['group_meta'][block, :groups]
        # Threads of a block are its groups' segments, one after another
        np.testing.assert_array_equal(
            meta[:, 0], np.cumsum(meta[:, 1]) - meta[:, 1])
        assert meta[:, 1].sum() <= plan['threads']
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert lanes * destinations <= max(plan['threads'], destinations)
        active = plan['items'][block, :meta[:, 1].sum()]
        assert (active[:, 1] % 2 == 1).all()
        assert (plan['items'][block, meta[:, 1].sum():] == 0).all()
        # A padded segment reads alpha inside its padded buffer
        reach = active[:, 0] + np.maximum(active[:, 1], viterbi.REGISTER_ROWS)
        assert reach.max(initial=0) <= plan['alpha_stride']


@pytest.mark.parametrize('axis,blocks', [
    ('small', 1), ('small', 4), ('tiny', 2), ('stft', 16)])
def test_cluster_plan_packs_the_dense_matrix(axis, blocks):
    axis = {'small': SMALL_AXIS, 'tiny': np.linspace(50., 8000., 31),
            'stft': STFT_AXIS}[axis]
    plan, floor = _plan(axis, blocks)
    values, offsets, lows, _ = viterbi.band_table(axis)
    np.testing.assert_array_equal(
        viterbi.plan_dense(plan, len(axis), floor),
        viterbi.band_dense(values, offsets, lows, floor))


def test_cluster_plan_of_the_harmonics_axis_fits_sixteen_blocks():
    plan, _ = _plan(STFT_AXIS, 16)
    bytes_needed = (
        16 * plan['table_rows'] + 8 * plan['alpha_stride'] +
        8 * viterbi.GROUP * plan['threads'] +
        4 * (viterbi.LOGFREQ_RING + 2) * plan['ring_stride'] +
        8 * plan['max_groups'])
    assert bytes_needed <= plan['shared_bytes'] <= viterbi.DECODE_SHARED_LIMIT
    assert plan['shared_bytes'] % 16 == 0
    assert plan['ring_stride'] >= plan['block_info'][:, 1].max()
    # Every block receives every block's destinations in 16-byte pieces
    assert plan['frame_bytes'] == 16 * sum(
        -(-int(count) // 4) for count in plan['block_info'][:, 1])
    assert plan['frame_bytes'] >= 4 * 2039
    assert plan['predecessor_stride'] % 8 == 0
    assert plan['predecessor_stride'] >= 2039
    # Fewer blocks cannot hold the table; the rule then has one choice
    for blocks in (1, 2, 4, 8):
        with pytest.raises(ValueError, match='cannot hold'):
            _plan(STFT_AXIS, blocks)
    assert viterbi.choose_cluster({16: plan}) == 16


def test_choose_cluster_takes_the_smallest_with_short_segments():
    plans = {blocks: _plan(np.linspace(50., 8000., 512), blocks)[0]
             for blocks in (1, 2, 4)}
    rows = {blocks: plan['segment_rows'].max()
            for blocks, plan in plans.items()}
    expected = min(
        (blocks for blocks in plans
         if rows[blocks] <= viterbi.SEGMENT_TARGET), default=4)
    assert viterbi.choose_cluster(plans) == expected
    assert viterbi.choose_cluster({1: _plan(SMALL_AXIS, 1)[0]}) == 1


@pytest.mark.parametrize('states,dtype', [
    (200, torch.int16), (2039, torch.int16), (2 ** 15, torch.int16),
    (2 ** 15 + 1, torch.int32)])
def test_logfreq_predecessor_width_follows_the_states(states, dtype):
    assert viterbi.logfreq_entry_dtype(states) == dtype


def _order_key(value):
    """`order_key` of the kernels: NaN above +inf, -0 equal to +0"""
    if np.isnan(value):
        return 0xFFFFFFFF
    bits = int(np.float32(value + np.float32(0.)).view(np.uint32))
    return (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000


def _emulate_cluster(plan, floor, observation, initial, chunk_rows=7):
    """The cluster route of `csrc/viterbi_logfreq.cu` in float32 numpy

    Phase 1: every thread scans its segment for its group's destinations
    on a strict '>'. Phase 2: per destination the lanes combine the
    segments' results, take the floor candidate where it is better, add
    the observation, and every block's best (key of alpha + floor, first
    index) is merged by a maximum over packed words. Then the backtrace
    over chunks handed from block to block.
    """
    frames, states = observation.shape
    threads, group = plan['threads'], viterbi.GROUP
    held = viterbi.REGISTER_ROWS
    predecessors = np.zeros((frames, states), np.int32)
    alpha = np.zeros(plan['alpha_stride'], np.float32)
    word = 0
    with np.errstate(invalid='ignore'):
        for t in range(frames):
            current = np.zeros_like(alpha)
            next_word = 0
            if t:
                floor_index = 0xFFFFFFFF - (word & 0xFFFFFFFF)
                floor_best = (alpha[floor_index] + floor, floor_index)
            for block in range(plan['blocks']):
                first, count, lanes, _ = plan['block_info'][block]
                items = plan['items'][block]
                best = np.full((threads, group), -np.inf, np.float32)
                arg = np.full((threads, group), INT_MAX, np.int64)
                for r in range(max(held, items[:, 1].max()) if t else 0):
                    if r < held:
                        entries = plan['register_rows'][block, r]
                        live = items[:, 1] > 0
                    else:
                        live = items[:, 1] > r
                        entries = plan['image'][block][np.where(
                            live, items[:, 2] + (r - held) * items[:, 3], 0)]
                    score = alpha[np.minimum(
                        items[:, 0] + r, len(alpha) - 1)][:, None] + entries
                    update = (score > best) & live[:, None]
                    best = np.where(update, score, best)
                    arg = np.where(update, items[:, :1] + r, arg)
                for slot in range(count):
                    j = int(first) + slot
                    if not t:
                        value = initial[j] + observation[0, j]
                    else:
                        thread, segments = plan['group_meta'][
                            block, slot // group]
                        by_lane = []
                        for lane in range(lanes):
                            own = (np.float32(-np.inf), INT_MAX)
                            for s in range(lane, segments, lanes):
                                if best[thread + s, slot % group] > own[0]:
                                    own = (best[thread + s, slot % group],
                                           arg[thread + s, slot % group])
                            by_lane.append(own)
                        own = by_lane[0]
                        for other in by_lane[1:]:
                            if other[0] > own[0] or (
                                    other[0] == own[0] and other[1] < own[1]):
                                own = other
                        if _better(floor_best, own):
                            own = floor_best
                        predecessors[t, j] = own[1]
                        value = own[0] + observation[t, j]
                    current[j] = value
                    next_word = max(
                        next_word,
                        (_order_key(value + floor) << 32) | (0xFFFFFFFF - j))
            alpha, word = current, next_word
    state = max(
        (_order_key(alpha[j]) << 32) | (0xFFFFFFFF - j)
        for j in range(states))
    state = 0xFFFFFFFF - (state & 0xFFFFFFFF)
    path = np.empty(frames, np.int32)
    path[-1] = state
    hi = frames - 1
    while hi >= 1:
        lo = max(1, hi - chunk_rows + 1)
        for t in range(hi, lo - 1, -1):
            state = predecessors[t, state]
            path[t - 1] = state
        hi = lo - 1
    return predecessors, alpha[:states], path


def _logfreq_problem(kind, frames=25, states=200):
    rng = np.random.default_rng(len(kind) + frames)
    observation = np.array(jax.nn.log_softmax(jnp.asarray(
        3 * rng.standard_normal((frames, states)), jnp.float32), axis=-1))
    if kind == 'ties':
        observation = np.round(
            rng.standard_normal((frames, states))).astype(np.float32)
    elif kind in ('masked', 'nan', 'empty_band'):
        low = rng.integers(0, states - 30, frames)
        columns = np.arange(states)[None]
        band = (columns >= low[:, None]) & (columns < low[:, None] + 25)
        observation = np.where(band, observation, -np.inf).astype(np.float32)
        if kind == 'nan':
            observation[frames // 2] = np.nan
        if kind == 'empty_band':
            observation[frames // 2] = -np.inf
    elif kind == 'binade':
        observation = np.zeros((frames, states), np.float32)
        observation[0] = -4300.
        observation[0, 40:52] = (
            np.float32(-4090.) -
            rng.integers(1, 4, 12) * np.float32(2. ** -12))
        observation[1:] = np.round(rng.standard_normal((frames - 1, states)))
        observation[1, 150] = 200.
    initial = np.log(np.linspace(1., .01, states) /
                     np.linspace(1., .01, states).sum()).astype(np.float32)
    if kind == 'binade':
        initial = np.zeros(states, np.float32)
    return observation, initial


@pytest.mark.parametrize('blocks', [1, 2, 16])
@pytest.mark.parametrize('kind', [
    'random', 'ties', 'masked', 'nan', 'empty_band', 'binade'])
def test_cluster_algorithm_matches_plain_scan(kind, blocks):
    observation, initial = _logfreq_problem(kind)
    plan, floor = _plan(SMALL_AXIS, blocks)
    indices, final_alpha = viterbi.forward_plain(
        torch.from_numpy(observation),
        viterbi.logfreq_transition_dense(SMALL_AXIS),
        torch.from_numpy(initial))
    predecessors, alpha, path = _emulate_cluster(
        plan, floor, observation, initial)
    np.testing.assert_array_equal(predecessors, indices.numpy())
    np.testing.assert_array_equal(alpha, final_alpha.numpy())
    np.testing.assert_array_equal(
        path, viterbi.backtrace_plain(indices, final_alpha).numpy())


@pytest.mark.parametrize('frames', [1, 2])
def test_cluster_algorithm_on_the_shortest_inputs(frames):
    observation, initial = _logfreq_problem('random', frames=frames)
    plan, floor = _plan(SMALL_AXIS, 4, threads=128)
    path = _emulate_cluster(plan, floor, observation, initial)[2]
    np.testing.assert_array_equal(path, viterbi.decode_logfreq(
        torch.from_numpy(observation), SMALL_AXIS,
        torch.from_numpy(initial)).numpy())


def test_decode_logfreq_takes_a_batch_on_cpu():
    kinds = ('random', 'nan', 'ties')
    problems = [_logfreq_problem(kind) for kind in kinds]
    initial = torch.from_numpy(problems[0][1])
    batch = torch.stack([torch.from_numpy(p[0]) for p in problems])
    before = viterbi.decode_logfreq.launches
    paths = viterbi.decode_logfreq(batch, SMALL_AXIS, initial)
    assert viterbi.decode_logfreq.launches == before
    assert paths.shape == (3, 25) and paths.dtype == torch.int32
    for path, sequence in zip(paths, batch):
        np.testing.assert_array_equal(
            path.numpy(),
            viterbi.decode_logfreq(sequence, SMALL_AXIS, initial).numpy())
