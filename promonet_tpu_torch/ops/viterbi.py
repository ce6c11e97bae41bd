"""Viterbi decoding (counterpart of `promonet_tpu/ops/viterbi.py`)

`decode` runs the hand-written CUDA kernel (`csrc/viterbi.cu`) for a
CUDA tensor and the plain PyTorch forward pass and backtrace for a CPU
tensor. The kernel replaces the Pallas kernel
`promonet_tpu/ops/viterbi.py::_decode_kernel` (its `pallas_call` is at
`_decode_pallas`); see the note in `csrc/viterbi.cu` for its design and
bound. The kernel scans the band form of the transition (`band_form`,
built once per matrix by `banded` and cached), the plain version the
dense matrix. Both break ties towards the first index, as `jnp.argmax`
does, and only add and compare, so their paths are bit-identical.

`decode_logfreq` is the large-state decode of the harmonics path, under
the log-frequency locality transition of `logfreq_transition_dense`. For
a CUDA tensor it runs `csrc/viterbi_logfreq.cu`, which replaces the
Pallas kernel `_logfreq_forward_kernel` (its `pallas_call` is at
`_logfreq_forward_pallas`) and reads the transition from a band table
(`band_table`) built once per frequency axis and packed for the kernel
(`cluster_plan`): one thread block cluster decodes one sequence, a batch
is one launch. An axis whose table fits no cluster takes the kernel's
grid route (`_logfreq_plan_on` holds the rule). For a CPU tensor it runs
the plain forward pass over the dense matrix. Paths are bit-identical
here too.
"""
import ctypes
import functools
import weakref

import numpy as np
import torch

from ..utils import timer
from . import _build

NEG_INF = -1e30

# Geometry of `csrc/viterbi.cu`: observation rows in flight, and the
# dynamic shared memory a block may take (a Hopper block has 227 KB, of
# which the kernel's static arrays take under 1 KB)
DECODE_RING = 4
DECODE_SHARED_LIMIT = 224 * 1024


def triangular_transition(num_states, width, dtype=torch.float32):
    """Log transition with transition[i, j] ∝ max(0, width - |i - j|)

    Row-normalized in float64 numpy, -1e30 outside the band.
    """
    index = np.arange(num_states)
    tri = np.maximum(0., width - np.abs(index[:, None] - index[None, :]))
    tri = tri / tri.sum(axis=1, keepdims=True)
    log = np.where(tri > 0, np.log(np.maximum(tri, 1e-12)), NEG_INF)
    return torch.from_numpy(log).to(dtype)


def _runs(dense, floor):
    """Per column of `dense`, the run of sources that differ from `floor`

    Returns values (total,), offsets (N + 1,) int64 and lows (N,) int64:
    run j is dense[lows[j]:lows[j] + length_j, j], from the first to the
    last source whose entry is not `floor`, stored at values[offsets[j]:
    offsets[j + 1]]. A NaN differs from every floor.
    """
    num_states = dense.shape[0]
    above = dense != floor
    occupied = above.any(axis=0)
    lows = np.where(occupied, above.argmax(axis=0), 0)
    highs = np.where(occupied, num_states - above[::-1].argmax(axis=0), 0)
    offsets = np.concatenate([[0], np.cumsum(highs - lows)])
    if offsets[-1] >= 2 ** 31:
        raise ValueError('The band table needs 32-bit offsets')
    sources = np.arange(num_states)[None, :]
    in_run = (sources >= lows[:, None]) & (sources < highs[:, None])
    return np.ascontiguousarray(dense.T[in_run]), offsets, lows


def band_form(transition):
    """A dense (N, N) float32 transition stored run by run

    `floor` is the matrix's smallest entry; run j covers every source of
    column j whose entry differs from it (see `_runs`), so values,
    offsets, lows and floor carry the whole matrix (`band_dense` rebuilds
    it). `has_floor` says whether any entry lies outside the runs: a
    matrix of distinct entries has runs [0, N) and no use for the floor.

    Returns
        values (total,) float32, offsets (N + 1,) int32, lows (N,) int32,
        floor (numpy float32), has_floor (bool)
    """
    dense = np.ascontiguousarray(_as_numpy(transition), np.float32)
    if dense.ndim != 2 or dense.shape[0] != dense.shape[1]:
        raise ValueError(f'Transition of shape {dense.shape} is not square')
    floor = np.float32(dense.min()) if dense.size else np.float32(0)
    values, offsets, lows = _runs(dense, floor)
    return (
        values, offsets.astype(np.int32), lows.astype(np.int32), floor,
        bool(len(values) < dense.size))


def band_dense(values, offsets, lows, floor):
    """The dense matrix that a band form stands for (inverse of `band_form`)"""
    num_states = len(lows)
    dense = np.full((num_states, num_states), floor, np.float32)
    for j in range(num_states):
        length = offsets[j + 1] - offsets[j]
        dense[lows[j]:lows[j] + length, j] = values[offsets[j]:offsets[j + 1]]
    return dense


class Band:
    """A transition analysed for `decode`: the dense tensor and its band
    form on the same device. Make one with `banded`; `decode` takes it in
    place of the dense tensor and then does no work per call."""

    def __init__(self, dense):
        self.dense = dense.contiguous()
        values, offsets, lows, floor, self.has_floor = band_form(dense)
        self.floor = float(floor)
        self.num_states = len(lows)
        self.entries = len(values)
        self.max_run = int(np.diff(offsets).max()) if len(lows) else 0
        device = dense.device
        self.values, self.offsets, self.lows = (
            torch.from_numpy(array).to(device)
            for array in (values, offsets, lows))
        # The narrowest predecessor that holds a state index
        self.entry_dtype = (
            torch.uint8 if self.num_states <= 2 ** 8 else
            torch.int16 if self.num_states <= 2 ** 15 else torch.int32)
        plan = decode_plan(self.num_states, self.entries, 1)
        self.table_in_shared = plan['table_in_shared']


def decode_plan(num_states, entries, num_frames, entry_bytes=1):
    """Shared memory of one `csrc/viterbi.cu` block, in bytes

    The forward pass keeps two alpha vectors, DECODE_RING observation
    rows, the runs' offsets and first sources and, where they fit, the
    runs' values; the backtrace reuses the space for its chunk of
    predecessors, which is as long as the limit allows.
    """
    fixed = 4 * ((2 + DECODE_RING) * num_states + 2 * num_states + 1)
    if fixed > DECODE_SHARED_LIMIT:
        raise ValueError(
            f'The Viterbi kernel keeps {2 + DECODE_RING} rows of all '
            f'{num_states} states in shared memory; too many states')
    table_in_shared = entries if fixed + 4 * entries <= DECODE_SHARED_LIMIT \
        else 0
    forward = fixed + 4 * table_in_shared
    backtrace = min(
        DECODE_SHARED_LIMIT,
        max(num_frames, 1) * num_states * entry_bytes)
    return dict(
        table_in_shared=table_in_shared,
        shared_bytes=-(-max(forward, backtrace, num_states * entry_bytes)
                       // 16) * 16)


# Band forms of dense tensors that `decode` has seen, by id(tensor); an
# entry dies with its tensor and is rebuilt when the tensor was written to
_BANDS = {}


def banded(transition):
    """The cached `Band` of a dense transition tensor (analysed once)

    A tensor made under `torch.inference_mode` has no version counter to
    tell a later write by, so its band is analysed anew on each call.
    """
    if isinstance(transition, Band):
        return transition
    key = id(transition)
    cached = not transition.is_inference()
    hit = _BANDS.get(key) if cached else None
    if hit is not None and hit[0]() is transition \
            and hit[1] == transition._version:
        return hit[2]
    if transition.dtype != torch.float32 or transition.dim() != 2 \
            or transition.shape[0] != transition.shape[1]:
        raise ValueError(
            f'Viterbi kernel takes a square float32 transition; got '
            f'{transition.dtype} {tuple(transition.shape)}')
    band = Band(transition.detach())
    if cached:
        _BANDS[key] = (
            weakref.ref(transition, lambda _, key=key: _BANDS.pop(key, None)),
            transition._version, band)
    return band


def decode(observation, transition, initial):
    """Viterbi-decode sequences of log-probability frames

    Arguments
        observation: (T, N) per-frame log-probabilities, or (B, T, N)
        transition: (N, N); transition[i, j] is the log-probability of
            moving from state i to state j. A `Band` (from `banded`)
            stands for its dense tensor and saves the look-up
        initial: (N,) log initial distribution

    Returns
        path: (T,) or (B, T) int32 state indices

    A call is the span `viterbi.decode` (`utils.timer.span`).
    """
    with timer.span('viterbi.decode'):
        if observation.device.type == 'cpu':
            dense = transition.dense if isinstance(transition, Band) \
                else transition
            if observation.dim() == 3:
                return torch.stack([
                    backtrace_plain(*forward_plain(sequence, dense, initial))
                    for sequence in observation])
            return backtrace_plain(
                *forward_plain(observation, dense, initial))
        if observation.device.type == 'cuda':
            return _decode_cuda(observation, transition, initial)
    raise ValueError(f'No Viterbi decode for device {observation.device}')


decode.launches = 0


def from_probabilities(observation, transition=None, initial=None):
    """`decode` of probabilities instead of their logs (torbi's entry point)

    Each input is clipped to 1e-12 before the log. transition None is
    uniform (N, N) and initial None uniform (N,), in the observation's
    dtype on its device; a CUDA observation reaches the kernel, the
    uniform transition as a dense matrix.
    """
    num_states = observation.shape[-1]
    like = dict(dtype=observation.dtype, device=observation.device)
    if transition is None:
        transition = torch.full((num_states, num_states), 1. / num_states,
                                **like)
    if initial is None:
        initial = torch.full((num_states,), 1. / num_states, **like)

    def log(probabilities):
        return torch.log(torch.clamp(probabilities, min=1e-12))

    return decode(log(observation), log(transition), log(initial))


def forward_plain(observation, transition, initial):
    """Forward pass; returns ((T, N) argmax predecessors, final alpha)

    Row 0 of the predecessors is a zero placeholder, so that row t holds
    the predecessors of the states at frame t.
    """
    num_frames, num_states = observation.shape
    indices = torch.zeros(
        (num_frames, num_states), dtype=torch.int32,
        device=observation.device)
    alpha = initial + observation[0]
    for t in range(1, num_frames):
        # torch.max over a dim returns the first maximal index
        best, arg = torch.max(alpha[:, None] + transition, dim=0)
        indices[t] = arg.to(torch.int32)
        alpha = best + observation[t]
    return indices, alpha


def backtrace_plain(indices, final_alpha):
    """Follow the stored predecessors back from the best final state"""
    indices = indices.cpu().numpy()
    path = np.empty(indices.shape[0], np.int32)
    path[-1] = int(torch.argmax(final_alpha))
    for t in range(indices.shape[0] - 1, 0, -1):
        path[t - 1] = indices[t, path[t]]
    return torch.from_numpy(path).to(final_alpha.device)


def _decode_cuda(observation, transition, initial, phases=3, scratch=None):
    """Launch `csrc/viterbi.cu`

    `phases` is 1 for the forward pass alone (the path's last entry and
    the predecessors are written), 2 for the backtrace alone over the
    (predecessors, path) pair in `scratch`, 3 for both. Returns the path;
    with phases=1 the pair (predecessors, path), to hand back as `scratch`.
    """
    batched = observation.dim() == 3
    if not batched:
        observation = observation[None]
    if observation.dim() != 3:
        raise ValueError(
            f'Viterbi decode takes (T, N) or (B, T, N); got '
            f'{tuple(observation.shape)}')
    batch, num_frames, num_states = observation.shape
    band = banded(transition)
    for name, tensor, shape in (
        ('observation', observation, (batch, num_frames, num_states)),
        ('transition', band.dense, (num_states, num_states)),
        ('initial', initial, (num_states,)),
    ):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape \
                or tensor.device != observation.device:
            raise ValueError(
                f'Viterbi kernel takes float32 {name} of shape {shape} on '
                f'{observation.device}; got {tensor.dtype} '
                f'{tuple(tensor.shape)} on {tensor.device}')
    if num_frames < 1 or batch < 1:
        raise ValueError('Viterbi decode needs at least one frame')
    observation = observation.contiguous()
    initial = initial.contiguous()
    device = observation.device
    entry_bytes = band.entry_dtype.itemsize
    plan = decode_plan(num_states, band.entries, num_frames, entry_bytes)
    if scratch is None:
        scratch = (
            torch.empty(
                (batch, num_frames, num_states), dtype=band.entry_dtype,
                device=device),
            torch.empty((batch, num_frames), dtype=torch.int32, device=device))
    predecessors, path = scratch
    function = _function()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = function(
            observation.data_ptr(),
            band.dense.data_ptr(),
            initial.data_ptr(),
            band.values.data_ptr(),
            band.offsets.data_ptr(),
            band.lows.data_ptr(),
            predecessors.data_ptr(),
            path.data_ptr(),
            batch,
            num_frames,
            num_states,
            band.table_in_shared,
            int(band.has_floor),
            band.floor,
            band.max_run,
            entry_bytes,
            phases,
            plan['shared_bytes'],
            stream)
    _build.check(status, 'viterbi')
    decode.launches += 1
    if phases == 1:
        return scratch
    return path if batched else path[0]


@functools.lru_cache(maxsize=None)
def _function():
    function = _build.library('viterbi').viterbi_decode
    function.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    function.restype = ctypes.c_int
    return function


###############################################################################
# Large-state decode under the log-frequency locality transition
###############################################################################


# Probability floor of a move between bins too far apart
LOGFREQ_FLOOR = 1e-12

# Geometry of the cluster route of `csrc/viterbi_logfreq.cu`: one thread
# block cluster decodes one sequence. Destinations are taken GROUP at a
# time (one 16-byte table load serves a source row of a whole group), a
# group's rows are cut into segments of one thread each, and a thread keeps
# the first REGISTER_ROWS rows of its segment in registers for the whole
# decode and the rest in shared memory. A block has at most CLUSTER_THREADS
# threads, so that each may take 128 registers. LOGFREQ_RING observation
# rows are in flight.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_THREADS = 512
GROUP = 4
REGISTER_ROWS = 12
LOGFREQ_RING = 4

# The route rule takes the smallest cluster whose threads scan at most
# this many rows each; where none does, the largest that fits
SEGMENT_TARGET = 13

# Split of the groups over a cluster's blocks: a destination costs a block
# about as much as this many table rows (its share of the second phase of
# a frame: combining the segments' results, the stores to every block).
# `chip_smoke.py` times the decode with this value, with 0, with a quarter
# and with four times the value
DESTINATION_ROWS = 8

# Geometry of the grid route (the cooperative kernel for axes that fit no
# cluster): one warp scans one destination's run, and a destination costs
# about as much as RUN_OVERHEAD further warp steps for its reduction and
# its stores (8 measured best on an H100 at 2039 states while that axis
# took this route: 1.7 times faster than 0, within 3% of 16)
WARP = 32
RUN_OVERHEAD = 8

# Dynamic shared memory a block of the grid route may take for the alpha
# vector, its observations and its slice of the band table
SHARED_BUDGET = 160 * 1024


def logfreq_transition_dense(frequencies, locality=3.5, dtype=torch.float32):
    """The harmonics transition as an explicit (N, N) log matrix

    transition[i, j] ∝ max(0, 1 - locality * |log2 fi - log2 fj|),
    row-normalized and floored at 1e-12 before the log, in float64 numpy
    and then cast.
    """
    frequencies = _as_numpy(frequencies).astype(np.float64)
    log_frequencies = np.log2(np.maximum(frequencies, 1e-30))
    tri = np.maximum(0., 1. - locality * np.abs(
        log_frequencies[:, None] - log_frequencies[None, :]))
    tri = tri / np.maximum(tri.sum(axis=1, keepdims=True), 1e-30)
    return torch.from_numpy(np.log(np.maximum(tri, LOGFREQ_FLOOR))).to(dtype)


def decode_logfreq(observation, frequencies, initial, locality=3.5):
    """Viterbi decode under the log-frequency locality transition

    Equal to `decode(observation, logfreq_transition_dense(frequencies),
    initial)`, for state spaces whose dense transition is too large to
    stream every frame (16.6 MB at the 2039 bins of the harmonics decode).
    On the card a batch is one launch, one thread block cluster per
    sequence (see `logfreq_route` for the axes that take the grid route,
    one launch per sequence).

    Arguments
        observation: (T, N) log-probability frames, or (B, T, N); -inf
            entries allowed
        frequencies: (N,) static frequency axis in Hz (numpy or tensor)
        initial: (N,) log initial distribution

    Returns
        path: (T,) or (B, T) int32 state indices

    A call is the span `viterbi.decode_logfreq`.
    """
    with timer.span('viterbi.decode_logfreq'):
        if observation.device.type == 'cpu':
            transition = logfreq_transition_dense(frequencies, locality)
            if observation.dim() == 3:
                return torch.stack([
                    backtrace_plain(
                        *forward_plain(sequence, transition, initial))
                    for sequence in observation])
            return backtrace_plain(
                *forward_plain(observation, transition, initial))
        if observation.device.type == 'cuda':
            return _decode_logfreq_cuda(
                observation, frequencies, initial, locality)
    raise ValueError(f'No Viterbi decode for device {observation.device}')


# Kernel launches, and how many of them took each route
decode_logfreq.launches = 0
decode_logfreq.routes = {'cluster': 0, 'grid': 0}


def band_table(frequencies, locality=3.5):
    """The dense log-frequency transition stored band by band

    For destination j the run holds transition[lows[j]:highs[j], j], from
    the first to the last source above the floor log(1e-12); runs follow
    each other in `values`, run j starting at `offsets[j]`. Every entry
    outside the runs equals `floor`, so the table carries the whole
    matrix.

    Returns
        values (total,) float32, offsets (N + 1,) int32, lows (N,) int32,
        floor (numpy float32)
    """
    dense = logfreq_transition_dense(frequencies, locality).numpy()
    floor = np.float32(np.log(LOGFREQ_FLOOR))
    values, offsets, lows = _runs(dense, floor)
    return values, offsets.astype(np.int32), lows.astype(np.int32), floor


def logfreq_entry_dtype(num_states):
    """The narrowest predecessor of the cluster route that holds a state"""
    return torch.int16 if num_states <= 2 ** 15 else torch.int32


def _split(cost, parts):
    """Cut a sequence into `parts` contiguous ranges of about equal cost

    Returns starts (parts + 1,) int64; a range may be empty.
    """
    total = np.cumsum(cost)
    if not len(total):
        return np.zeros(parts + 1, np.int64)
    targets = total[-1] * np.arange(1, parts) / parts
    inner = np.searchsorted(total, targets, side='left') + 1
    return np.concatenate(
        [[0], np.minimum(inner, len(total)), [len(total)]]).astype(np.int64)


def partition_destinations(offsets, blocks):
    """Split the destinations into `blocks` contiguous ranges of equal work

    For the grid route. Returns starts (blocks + 1,) int32; block b decodes
    the destinations starts[b]:starts[b + 1].
    """
    lengths = np.diff(offsets.astype(np.int64))
    return _split(-(-lengths // WARP) + RUN_OVERHEAD, blocks).astype(np.int32)


def group_rows(offsets, lows):
    """Source rows of each group of GROUP neighbouring destinations

    Returns first (G,) and rows (G,) int64: group g scans the sources
    first[g]:first[g] + rows[g], the union of its destinations' runs. A
    source inside the union and outside a destination's own run scores
    that destination's dense entry, the floor.
    """
    offsets, lows = offsets.astype(np.int64), lows.astype(np.int64)
    num_states = len(lows)
    lengths = np.diff(offsets)
    groups = -(-num_states // GROUP)
    padding = groups * GROUP - num_states
    first = np.concatenate([
        np.where(lengths > 0, lows, num_states),
        np.full(padding, num_states)]).reshape(groups, GROUP).min(axis=1)
    last = np.concatenate([
        np.where(lengths > 0, lows + lengths, 0),
        np.zeros(padding, np.int64)]).reshape(groups, GROUP).max(axis=1)
    rows = np.maximum(last - first, 0)
    return np.where(rows > 0, first, 0), rows


def _segment_rows(rows, threads):
    """Smallest odd segment length that cuts `rows` into <= threads parts"""
    if (rows > 0).sum() > threads:
        raise ValueError('More groups of destinations than threads')
    length = 1
    while (-(-rows // length)).sum() > threads:
        length += 2
    return length


def cluster_plan(values, offsets, lows, floor, blocks, threads=None):
    """Launch geometry and packed table of the cluster route

    The groups (see `group_rows`) are split over the `blocks` thread
    blocks of a cluster, contiguously and by cost (table rows plus
    DESTINATION_ROWS per destination). Inside a block each group's rows
    are cut into segments of an odd length (so that neighbouring threads
    read neighbouring banks), one thread each: thread t of group g scans
    the sources src:src + length for the group's destinations. A
    segment's rectangle is padded with -inf, which never wins a strict
    '>'. Its first REGISTER_ROWS rows go to `register_rows`, the rest to
    the block's `image` of shared memory, row-major over the group's
    segments so that a warp reads consecutive 16-byte words.

    Returns a dict of
        items (blocks, threads, 4) int32: src, length, index of the
            thread's first row in the image, the image's row stride
        register_rows (blocks, REGISTER_ROWS, threads, GROUP) float32
        image (blocks, table_rows, GROUP) float32
        group_meta (blocks, max_groups, 2) int32: a group's first thread
            and its number of segments
        block_info (blocks, 4) int32: first destination, destinations,
            lanes that share a destination in the second phase, groups
        starts (blocks + 1,) first group of each block
        segment_rows (blocks,) longest segment of each block
        blocks, threads, table_rows, alpha_stride, ring_stride,
        max_groups, predecessor_stride, shared_bytes, and frame_bytes, the
        bytes of new alpha that reach a block each frame
    and raises ValueError where a block's share does not fit its shared
    memory (DECODE_SHARED_LIMIT).
    """
    offsets64, lows64 = offsets.astype(np.int64), lows.astype(np.int64)
    num_states = len(lows)
    lengths = np.diff(offsets64)
    first, rows = group_rows(offsets, lows)
    starts = _split(rows + DESTINATION_ROWS * GROUP, blocks)
    if threads is None:
        # As many threads as the busiest block has rows or destinations
        busiest = max(
            max(int(rows[a:b].sum()), int(b - a) * GROUP)
            for a, b in zip(starts[:-1], starts[1:]))
        threads = int(min(CLUSTER_THREADS, max(128, -(-busiest // 32) * 32)))

    geometry = []
    for a, b in zip(starts[:-1], starts[1:]):
        block_rows = rows[a:b]
        longest = _segment_rows(block_rows, threads)
        segments = -(-block_rows // longest)
        length = -(-block_rows // np.maximum(segments, 1))
        length = length + (length % 2 == 0) * (length > 0)
        segments = -(-block_rows // np.maximum(length, 1))
        geometry.append((int(a), int(b), segments, length))

    max_groups = max(1, max(b - a for a, b, _, _ in geometry))
    table_rows = max(1, max(
        int((segments * np.maximum(length - REGISTER_ROWS, 0)).sum())
        for _, _, segments, length in geometry))
    max_destinations = max(
        min(b * GROUP, num_states) - min(a * GROUP, num_states)
        for a, b, _, _ in geometry)
    # Sources a padded segment reads past the axis
    overshoot = max(
        [0] + [int((first[a:b] + (segments - 1) * length + np.maximum(
            length, REGISTER_ROWS)).max()) - num_states
               for a, b, segments, length in geometry if b > a])
    alpha_stride = -(-(num_states + max(overshoot, 0)) // 4) * 4
    ring_stride = max(4, -(-max_destinations // 4) * 4)
    predecessor_stride = -(-num_states // 8) * 8
    shared_bytes = (
        16 * table_rows + 4 * 2 * alpha_stride + 8 * GROUP * threads +
        4 * (LOGFREQ_RING + 2) * ring_stride + 8 * max_groups)
    shared_bytes = -(-max(shared_bytes, 2 * predecessor_stride) // 16) * 16
    if shared_bytes > DECODE_SHARED_LIMIT \
            or logfreq_entry_dtype(num_states) != torch.int16:
        raise ValueError(
            f'A cluster of {blocks} blocks cannot hold the band table of '
            f'{num_states} states ({shared_bytes} bytes of shared memory a '
            'block)')

    items = np.zeros((blocks, threads, 4), np.int32)
    register_rows = np.full(
        (blocks, REGISTER_ROWS, threads, GROUP), -np.inf, np.float32)
    image = np.full((blocks, table_rows, GROUP), -np.inf, np.float32)
    group_meta = np.zeros((blocks, max_groups, 2), np.int32)
    block_info = np.zeros((blocks, 4), np.int32)
    for block, (a, b, segments, length) in enumerate(geometry):
        thread = image_row = 0
        for g in range(a, b):
            count, rows_each = int(segments[g - a]), int(length[g - a])
            group_meta[block, g - a] = thread, count
            if not count:
                continue
            # The dense entries of the group's rows, -inf past them
            rectangle = np.full(
                (count * rows_each, GROUP), -np.inf, np.float32)
            rectangle[:rows[g]] = floor
            for d in range(GROUP):
                j = g * GROUP + d
                if j < num_states and lengths[j]:
                    begin = lows64[j] - first[g]
                    rectangle[begin:begin + lengths[j], d] = values[
                        offsets64[j]:offsets64[j + 1]]
            rectangle = rectangle.reshape(count, rows_each, GROUP)
            held = min(rows_each, REGISTER_ROWS)
            register_rows[block, :held, thread:thread + count] = \
                rectangle[:, :held].transpose(1, 0, 2)
            rest = rows_each - held
            items[block, thread:thread + count, 0] = \
                first[g] + rows_each * np.arange(count)
            items[block, thread:thread + count, 1] = rows_each
            items[block, thread:thread + count, 2] = \
                image_row + np.arange(count)
            items[block, thread:thread + count, 3] = count
            image[block, image_row:image_row + rest * count] = \
                rectangle[:, held:].transpose(1, 0, 2).reshape(-1, GROUP)
            thread += count
            image_row += rest * count
        first_destination = min(a * GROUP, num_states)
        destinations = min(b * GROUP, num_states) - first_destination
        # Lanes that share a destination when the segments' results are
        # combined: as many as the block's threads allow, and no more
        # than the longest list of segments needs
        lanes = 1
        while lanes < 32 and 2 * lanes * destinations <= threads \
                and lanes < int(segments.max(initial=0)):
            lanes *= 2
        block_info[block] = first_destination, destinations, lanes, b - a
    return dict(
        items=items, register_rows=register_rows, image=image,
        group_meta=group_meta, block_info=block_info, starts=starts,
        segment_rows=np.array(
            [int(length.max(initial=0)) for _, _, _, length in geometry]),
        blocks=blocks, threads=threads, table_rows=table_rows,
        alpha_stride=alpha_stride, ring_stride=ring_stride,
        max_groups=max_groups, predecessor_stride=predecessor_stride,
        # Every block's destinations in 16-byte pieces
        frame_bytes=int(16 * (-(-block_info[:, 1] // GROUP)).sum()),
        shared_bytes=int(shared_bytes))


def plan_dense(plan, num_states, floor):
    """The dense matrix that a cluster plan's packed table stands for"""
    dense = np.full((num_states, num_states), floor, np.float32)
    for block in range(plan['blocks']):
        first_destination, _, _, groups = plan['block_info'][block]
        for g in range(groups):
            thread, count = plan['group_meta'][block, g]
            j = first_destination + g * GROUP
            width = min(GROUP, num_states - j)
            for t in range(thread, thread + count):
                src, length, row, stride = plan['items'][block, t]
                for r in range(length):
                    entries = plan['register_rows'][block, r, t] \
                        if r < REGISTER_ROWS else plan['image'][
                            block, row + (r - REGISTER_ROWS) * stride]
                    # -inf pads a segment's rectangle past the group's rows
                    if entries[0] != -np.inf:
                        dense[src + r, j:j + width] = entries[:width]
    return dense


def choose_cluster(plans):
    """The route rule among cluster plans {blocks: plan} that fit

    The smallest cluster whose threads scan at most SEGMENT_TARGET rows
    each; where none does, the largest.
    """
    for blocks in sorted(plans):
        if plans[blocks]['segment_rows'].max(initial=0) <= SEGMENT_TARGET:
            return blocks
    return max(plans)


def grid_plan(offsets, lows, blocks):
    """Launch geometry of the grid route; raises where a slice does not fit"""
    blocks = max(1, min(blocks, len(lows)))
    starts = partition_destinations(offsets, blocks)
    max_destinations = int(np.diff(starts).max())
    max_slice = int(np.diff(offsets[starts].astype(np.int64)).max())
    if 4 * (len(lows) + max_destinations + max_slice) > SHARED_BUDGET:
        raise ValueError(
            f'The log-frequency Viterbi kernel keeps all {len(lows)} states '
            "and a block's slice of the band table in shared memory; this "
            'axis is too long')
    return dict(
        starts=starts, blocks=blocks, max_destinations=max_destinations,
        max_slice=max_slice)


@functools.lru_cache(maxsize=8)
def _logfreq_plan_on(device, frequencies_bytes, locality, route):
    """Route, launch geometry and table on `device`, built once per axis

    The route rule. An axis takes the cluster route where the card has
    thread block clusters (compute capability 9 or above), a plan of one
    of CLUSTER_SIZES fits a block's shared memory (`cluster_plan`) and
    the card reports that it can place such a cluster
    (cudaOccupancyMaxActiveClusters); among those `choose_cluster`
    decides. Every other axis takes the grid route, and raises where that
    does not fit either. `route` overrides the rule for the checks:
    'grid', or the number of blocks of the cluster.
    """
    frequencies = np.frombuffer(frequencies_bytes, np.float64)
    values, offsets, lows, floor = band_table(frequencies, locality)
    device = torch.device(device)
    properties = torch.cuda.get_device_properties(device)

    plans = {}
    if route != 'grid' and properties.major >= 9:
        for blocks in CLUSTER_SIZES if route is None else (route,):
            try:
                plan = cluster_plan(values, offsets, lows, floor, blocks)
            except ValueError:
                continue
            with torch.cuda.device(device):
                placeable = _logfreq_library().viterbi_logfreq_max_clusters(
                    blocks, plan['threads'], plan['shared_bytes'])
            if placeable < 0:
                _build.check(-placeable, 'viterbi_logfreq')
            if placeable > 0:
                plans[blocks] = plan
    if plans:
        plan = plans[choose_cluster(plans)]
        plan['route'] = 'cluster'
        for name in ('items', 'register_rows', 'image', 'group_meta',
                     'block_info'):
            plan[name] = torch.from_numpy(plan[name]).to(device)
    elif route in (None, 'grid'):
        plan = grid_plan(offsets, lows, properties.multi_processor_count)
        plan['route'] = 'grid'
        plan['tensors'] = tuple(
            torch.from_numpy(array).to(device)
            for array in (values, offsets, lows, plan['starts']))
    else:
        raise ValueError(
            f'A cluster of {route} blocks cannot decode {len(lows)} states '
            f'on {properties.name}')
    plan['floor'] = float(floor)
    return plan


def logfreq_route(frequencies, device='cuda', locality=3.5):
    """('cluster', blocks in the cluster) or ('grid', blocks in the grid):
    how `decode_logfreq` decodes this axis on `device`"""
    frequencies = _as_numpy(frequencies).astype(np.float64)
    plan = _logfreq_plan_on(
        str(torch.device(device)), frequencies.tobytes(), float(locality),
        None)
    return plan['route'], plan['blocks']


# Sections of a frame of the cluster route whose cycles the kernel counts
# on request
LOGFREQ_SECTIONS = (
    'wait_for_alpha', 'phase_1', 'barrier_1', 'phase_2', 'barrier_2',
    'copies')


def _decode_logfreq_cuda(
    observation, frequencies, initial, locality, phases=3, scratch=None,
    route=None, cycles=None
):
    """Launch `csrc/viterbi_logfreq.cu`

    `phases` and `scratch` as in `_decode_cuda` (cluster route only);
    `route` overrides the route rule, for the checks. `cycles`, a
    (2, len(LOGFREQ_SECTIONS)) int64 tensor on the device, makes the
    cluster route run its counting variant: thread 0's cycles in each
    section of a frame, summed over the frames after the first, for the
    first and the last block of the first sequence's cluster.
    """
    batched = observation.dim() == 3
    if not batched:
        observation = observation[None]
    if observation.dim() != 3:
        raise ValueError(
            f'Viterbi decode takes (T, N) or (B, T, N); got '
            f'{tuple(observation.shape)}')
    batch, num_frames, num_states = observation.shape
    for name, tensor, shape in (
        ('observation', observation, (batch, num_frames, num_states)),
        ('initial', initial, (num_states,)),
    ):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape \
                or tensor.device != observation.device:
            raise ValueError(
                f'Viterbi kernel takes float32 {name} of shape {shape} on '
                f'{observation.device}; got {tensor.dtype} '
                f'{tuple(tensor.shape)} on {tensor.device}')
    if num_frames < 1 or batch < 1:
        raise ValueError('Viterbi decode needs at least one frame')
    frequencies = _as_numpy(frequencies).astype(np.float64)
    if frequencies.shape != (num_states,):
        raise ValueError(
            f'Viterbi decode over {num_states} states needs as many '
            f'frequencies; got {frequencies.shape}')
    plan = _logfreq_plan_on(
        str(observation.device), frequencies.tobytes(), float(locality),
        route)
    observation = observation.contiguous()
    initial = initial.contiguous()
    if plan['route'] == 'grid':
        if phases != 3:
            raise ValueError('The grid route decodes in one piece')
        path = torch.stack([
            _launch_logfreq_grid(sequence, initial, plan)
            for sequence in observation])
        return path if batched else path[0]

    device = observation.device
    if scratch is None:
        scratch = (
            torch.empty(
                (batch, num_frames, plan['predecessor_stride']),
                dtype=logfreq_entry_dtype(num_states), device=device),
            torch.empty((batch, num_frames), dtype=torch.int32, device=device))
    predecessors, path = scratch
    if cycles is None:
        cycles = torch.empty(0, dtype=torch.int64, device=device)  # null
    elif cycles.dtype != torch.int64 or cycles.device != device \
            or tuple(cycles.shape) != (2, len(LOGFREQ_SECTIONS)) \
            or not cycles.is_contiguous():
        raise ValueError(
            f'cycles is a contiguous (2, {len(LOGFREQ_SECTIONS)}) int64 '
            f'tensor on {device}')
    function = _logfreq_library().viterbi_logfreq_cluster_decode
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = function(
            observation.data_ptr(),
            initial.data_ptr(),
            plan['register_rows'].data_ptr(),
            plan['image'].data_ptr(),
            plan['items'].data_ptr(),
            plan['group_meta'].data_ptr(),
            plan['block_info'].data_ptr(),
            predecessors.data_ptr(),
            path.data_ptr(),
            batch,
            num_frames,
            num_states,
            plan['predecessor_stride'],
            plan['blocks'],
            plan['threads'],
            plan['table_rows'],
            plan['alpha_stride'],
            plan['ring_stride'],
            plan['max_groups'],
            plan['frame_bytes'],
            plan['floor'],
            phases,
            plan['shared_bytes'],
            cycles.data_ptr(),
            stream)
    _build.check(status, 'viterbi_logfreq')
    decode_logfreq.launches += 1
    decode_logfreq.routes['cluster'] += 1
    if phases == 1:
        return scratch
    return path if batched else path[0]


def _launch_logfreq_grid(observation, initial, plan):
    """One sequence through the cooperative kernel of the grid route"""
    num_frames, num_states = observation.shape
    values, offsets, lows, starts = plan['tensors']
    device = observation.device
    alpha = torch.empty((2, num_states), dtype=torch.float32, device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    predecessors = torch.empty(
        (num_frames, num_states), dtype=torch.int32, device=device)
    path = torch.empty(num_frames, dtype=torch.int32, device=device)
    function = _logfreq_library().viterbi_logfreq_decode
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = function(
            observation.data_ptr(),
            initial.data_ptr(),
            values.data_ptr(),
            offsets.data_ptr(),
            lows.data_ptr(),
            starts.data_ptr(),
            alpha.data_ptr(),
            counter.data_ptr(),
            predecessors.data_ptr(),
            path.data_ptr(),
            num_frames,
            num_states,
            plan['blocks'],
            plan['max_destinations'],
            plan['max_slice'],
            plan['floor'],
            stream)
    _build.check(status, 'viterbi_logfreq')
    decode_logfreq.launches += 1
    decode_logfreq.routes['grid'] += 1
    return path


@functools.lru_cache(maxsize=None)
def _logfreq_library():
    library = _build.library('viterbi_logfreq')
    library.viterbi_logfreq_decode.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    library.viterbi_logfreq_decode.restype = ctypes.c_int
    library.viterbi_logfreq_cluster_decode.argtypes = [
        ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    library.viterbi_logfreq_cluster_decode.restype = ctypes.c_int
    library.viterbi_logfreq_max_clusters.argtypes = [ctypes.c_int] * 3
    library.viterbi_logfreq_max_clusters.restype = ctypes.c_int
    return library


def _as_numpy(array):
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)
