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
