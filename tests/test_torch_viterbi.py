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
