"""Viterbi decoding (counterpart of `promonet_tpu/ops/viterbi.py`)

`decode` runs the hand-written CUDA kernel (`csrc/viterbi.cu`) for a
CUDA tensor and the plain PyTorch forward pass and backtrace for a CPU
tensor. The kernel replaces the Pallas kernel
`promonet_tpu/ops/viterbi.py::_decode_kernel` (its `pallas_call` is at
`_decode_pallas`); see the note in `csrc/viterbi.cu` for its design and
bound. Both versions break ties towards the first index, as
`jnp.argmax` does, and only add and compare, so their paths are
bit-identical.
"""
import ctypes

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
