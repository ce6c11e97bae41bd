"""Viterbi decoding (counterpart of `promonet_tpu/ops/viterbi.py`)

`decode` runs the hand-written CUDA kernel (`csrc/viterbi.cu`) for a
CUDA tensor and the plain PyTorch forward pass and backtrace for a CPU
tensor. The kernel replaces the Pallas kernel
`promonet_tpu/ops/viterbi.py::_decode_kernel` (its `pallas_call` is at
`_decode_pallas`); see the note in `csrc/viterbi.cu` for its design and
bound. Both versions break ties towards the first index, as
`jnp.argmax` does, and only add and compare, so their paths are
bit-identical.

`decode_logfreq` is the large-state decode of the harmonics path, under
the log-frequency locality transition of `logfreq_transition_dense`. For
a CUDA tensor it runs `csrc/viterbi_logfreq.cu`, which replaces the
Pallas kernel `_logfreq_forward_kernel` (its `pallas_call` is at
`_logfreq_forward_pallas`) and reads the transition from a band table
(`band_table`) built once per frequency axis; for a CPU tensor it runs
the plain forward pass over the dense matrix. Paths are bit-identical
here too.
"""
import ctypes
import functools

import numpy as np
import torch

from . import _build

NEG_INF = -1e30


def triangular_transition(num_states, width, dtype=torch.float32):
    """Log transition with transition[i, j] ∝ max(0, width - |i - j|)

    Row-normalized in float64 numpy, -1e30 outside the band.
    """
    index = np.arange(num_states)
    tri = np.maximum(0., width - np.abs(index[:, None] - index[None, :]))
    tri = tri / tri.sum(axis=1, keepdims=True)
    log = np.where(tri > 0, np.log(np.maximum(tri, 1e-12)), NEG_INF)
    return torch.from_numpy(log).to(dtype)


def decode(observation, transition, initial):
    """Viterbi-decode one sequence of log-probability frames

    Arguments
        observation: (T, N) per-frame log-probabilities
        transition: (N, N); transition[i, j] is the log-probability of
            moving from state i to state j
        initial: (N,) log initial distribution

    Returns
        path: (T,) int32 state indices
    """
    if observation.device.type == 'cpu':
        indices, final_alpha = forward_plain(observation, transition, initial)
        return backtrace_plain(indices, final_alpha)
    if observation.device.type == 'cuda':
        return _decode_cuda(observation, transition, initial)
    raise ValueError(f'No Viterbi decode for device {observation.device}')


decode.launches = 0


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


def _decode_cuda(observation, transition, initial):
    num_frames, num_states = observation.shape
    for name, tensor, shape in (
        ('observation', observation, (num_frames, num_states)),
        ('transition', transition, (num_states, num_states)),
        ('initial', initial, (num_states,)),
    ):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape \
                or tensor.device != observation.device:
            raise ValueError(
                f'Viterbi kernel takes float32 {name} of shape {shape} on '
                f'{observation.device}; got {tensor.dtype} '
                f'{tuple(tensor.shape)} on {tensor.device}')
    if num_frames < 1:
        raise ValueError('Viterbi decode needs at least one frame')
    observation = observation.contiguous()
    transition = transition.contiguous()
    initial = initial.contiguous()
    predecessors = torch.empty(
        (num_frames, num_states), dtype=torch.int32,
        device=observation.device)
    path = torch.empty(num_frames, dtype=torch.int32, device=observation.device)
    function = _function()
    with torch.cuda.device(observation.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = function(
            observation.data_ptr(),
            transition.data_ptr(),
            initial.data_ptr(),
            predecessors.data_ptr(),
            path.data_ptr(),
            1,
            num_frames,
            num_states,
            stream)
    _build.check(status, 'viterbi')
    decode.launches += 1
    return path


def _function():
    function = _build.library('viterbi').viterbi_decode
    function.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    function.restype = ctypes.c_int
    return function


###############################################################################
# Large-state decode under the log-frequency locality transition
###############################################################################


# Probability floor of a move between bins too far apart
LOGFREQ_FLOOR = 1e-12

# Launch geometry of `csrc/viterbi_logfreq.cu`: one warp scans one
# destination's run, and a destination costs about as much as
# RUN_OVERHEAD further warp steps for its reduction and its stores.
# `chip_smoke.py` times the decode with this value, with 0 (split by
# run length alone, 1.7 times slower on an H100 at 2039 states) and
# with twice the value (within 2%)
WARP = 32
RUN_OVERHEAD = 8

# Dynamic shared memory a block may take for the alpha vector, its
# observations and its slice of the band table (a Hopper block has 227 KB)
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

    Arguments
        observation: (T, N) log-probability frames; -inf entries allowed
        frequencies: (N,) static frequency axis in Hz (numpy or tensor)
        initial: (N,) log initial distribution

    Returns
        path: (T,) int32 state indices
    """
    if observation.device.type == 'cpu':
        transition = logfreq_transition_dense(frequencies, locality)
        indices, final_alpha = forward_plain(observation, transition, initial)
        return backtrace_plain(indices, final_alpha)
    if observation.device.type == 'cuda':
        return _decode_logfreq_cuda(
            observation, frequencies, initial, locality)
    raise ValueError(f'No Viterbi decode for device {observation.device}')


decode_logfreq.launches = 0


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
    num_states = dense.shape[0]
    floor = np.float32(np.log(LOGFREQ_FLOOR))
    above = dense != floor
    occupied = above.any(axis=0)
    lows = np.where(occupied, above.argmax(axis=0), 0)
    highs = np.where(occupied, num_states - above[::-1].argmax(axis=0), 0)
    offsets = np.concatenate([[0], np.cumsum(highs - lows)])
    if offsets[-1] >= 2 ** 31:
        raise ValueError('The band table needs 32-bit offsets')
    sources = np.arange(num_states)[None, :]
    in_run = (sources >= lows[:, None]) & (sources < highs[:, None])
    return (
        np.ascontiguousarray(dense.T[in_run]),
        offsets.astype(np.int32),
        lows.astype(np.int32),
        floor)


def partition_destinations(offsets, blocks):
    """Split the destinations into `blocks` contiguous ranges of equal work

    Returns starts (blocks + 1,) int32; block b decodes the destinations
    starts[b]:starts[b + 1].
    """
    lengths = np.diff(offsets.astype(np.int64))
    cost = np.cumsum(-(-lengths // WARP) + RUN_OVERHEAD)
    targets = cost[-1] * np.arange(1, blocks) / blocks
    inner = np.searchsorted(cost, targets, side='left') + 1
    starts = np.concatenate(
        [[0], np.minimum(inner, len(lengths)), [len(lengths)]])
    return starts.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _band_table_on(device, frequencies_bytes, locality):
    """Band table and launch geometry on `device`, built once per axis"""
    frequencies = np.frombuffer(frequencies_bytes, np.float64)
    values, offsets, lows, floor = band_table(frequencies, locality)
    device = torch.device(device)
    blocks = max(1, min(
        torch.cuda.get_device_properties(device).multi_processor_count,
        len(lows)))
    starts = partition_destinations(offsets, blocks)
    max_destinations = int(np.diff(starts).max())
    max_slice = int(np.diff(offsets[starts].astype(np.int64)).max())
    if 4 * (len(lows) + max_destinations + max_slice) > SHARED_BUDGET:
        raise ValueError(
            f'The log-frequency Viterbi kernel keeps all {len(lows)} states '
            "and a block's slice of the band table in shared memory; this "
            'axis is too long')
    tensors = tuple(
        torch.from_numpy(array).to(device)
        for array in (values, offsets, lows, starts))
    return tensors, float(floor), blocks, max_destinations, max_slice


def _decode_logfreq_cuda(observation, frequencies, initial, locality):
    num_frames, num_states = observation.shape
    for name, tensor, shape in (
        ('observation', observation, (num_frames, num_states)),
        ('initial', initial, (num_states,)),
    ):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape \
                or tensor.device != observation.device:
            raise ValueError(
                f'Viterbi kernel takes float32 {name} of shape {shape} on '
                f'{observation.device}; got {tensor.dtype} '
                f'{tuple(tensor.shape)} on {tensor.device}')
    if num_frames < 1:
        raise ValueError('Viterbi decode needs at least one frame')
    frequencies = _as_numpy(frequencies).astype(np.float64)
    if frequencies.shape != (num_states,):
        raise ValueError(
            f'Viterbi decode over {num_states} states needs as many '
            f'frequencies; got {frequencies.shape}')
    (values, offsets, lows, starts), floor, blocks, max_destinations, \
        max_slice = _band_table_on(
            str(observation.device), frequencies.tobytes(), float(locality))
    observation = observation.contiguous()
    initial = initial.contiguous()
    device = observation.device
    alpha = torch.empty((2, num_states), dtype=torch.float32, device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    predecessors = torch.empty(
        (num_frames, num_states), dtype=torch.int32, device=device)
    path = torch.empty(num_frames, dtype=torch.int32, device=device)
    function = _logfreq_function()
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
            blocks,
            max_destinations,
            max_slice,
            floor,
            stream)
    _build.check(status, 'viterbi_logfreq')
    decode_logfreq.launches += 1
    return path


def _logfreq_function():
    function = _build.library('viterbi_logfreq').viterbi_logfreq_decode
    function.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    function.restype = ctypes.c_int
    return function


def _as_numpy(array):
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)
