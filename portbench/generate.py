"""The one traffic generator: a mix's parameters in, requests out

A traffic mix (`portbench/traffic/<name>.json`) names its driver and
gives its parameters as laws. Each law is sampled at the midpoints of N
equal strata of its distribution, `(i + 0.5) / N`, and the N values are
shuffled by the seed, each parameter on its own. So every seed serves
the same set of sizes and edits in another order and in other
combinations: the seed changes which request comes when, not how much
work the window holds. A law marked "order": "fixed" keeps one order for
every seed, so that a window that holds only part of the list holds the
same part whatever the seed.

Laws: {"law": "lognormal", "median", "sigma", "low", "high"},
{"law": "uniform", "low", "high"}, {"law": "loguniform", "low", "high"},
{"law": "integers", "count"} (0 to count - 1, "count" may name a
configuration key).
"""
import math
import zlib
from statistics import NormalDist

import numpy as np


def subseeds(seed, count):
    """`count` independent 32-bit seeds derived from `seed`"""
    return [int(value) for value in np.random.SeedSequence(
        int(seed)).generate_state(count)]


def strata(law, count, config=None):
    """The law's values at the midpoints of `count` equal strata"""
    u = (np.arange(count) + 0.5) / count
    kind = law['law']
    if kind == 'lognormal':
        normal = NormalDist()
        values = np.array([
            law['median'] * math.exp(law['sigma'] * normal.inv_cdf(p))
            for p in u])
        return np.clip(values, law['low'], law['high'])
    if kind == 'uniform':
        return law['low'] + (law['high'] - law['low']) * u
    if kind == 'loguniform':
        return np.exp(np.log(law['low']) + (
            np.log(law['high']) - np.log(law['low'])) * u)
    if kind == 'integers':
        total = law['count']
        if isinstance(total, str):
            total = getattr(config, total)
        return np.floor(u * total).astype(np.int64)
    raise ValueError(f'unknown law {kind}')


def draw(laws, count, seed, config=None):
    """{parameter: (count,) values}, each parameter's strata shuffled by
    its own stream of `seed`, or, for a law with "order": "fixed", by a
    stream of its name alone: the same order for every seed"""
    streams = subseeds(seed, len(laws))
    return {
        name: np.random.default_rng(
            zlib.crc32(name.encode()) if laws[name].get('order') == 'fixed'
            else stream).permutation(strata(laws[name], count, config))
        for stream, name in zip(streams, sorted(laws))}
