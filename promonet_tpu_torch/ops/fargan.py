"""FARGAN's subframe network as one launch: kernel K4

`csrc/fargan_subframe.cu` is `models.fargan.SubframeNetwork.forward` on
the card. It replaces no TPU kernel: the JAX package scans FARGAN's frame
loop under XLA. The port's loop stays a Python loop that calls the
subframe module once a subframe, so hooks on the module still see every
call, and each call is one launch instead of about 46.

A frame loop whose input lies on a CUDA device, in bfloat16, without
autograd and without training noise (`uses_kernel`) runs as K4 launches;
any other runs the plain PyTorch loop of `models.fargan`. K4's loop keeps
its buffers in a `Slots`: every subframe's inputs and results have slots
of their own, which no later launch writes. The launch of subframe i
reads its slots i and writes its output and states into slots i and
i + 1, its samples into the float32 history, and the next subframe's
previous subframe and pitch lookback into slots i + 1. The kernel counts
its launches in `subframe.launches`.
"""
import ctypes
import functools

import torch

from . import _build

# The widths the kernel is built for: FARGAN's class defaults, which the
# JAX package and the port build whatever the configuration says
HOPSIZE = 256
SUBFRAME = 64
STATE_WIDTHS = (HOPSIZE, HOPSIZE, HOPSIZE, 4 * SUBFRAME + 4)

# Devices whose tensors take the kernel
KERNEL_DEVICES = ('cuda',)


def uses_kernel(x, dtype, noise=None):
    """Whether a subframe over `x` in `dtype` runs as K4: on a CUDA
    device, in bfloat16, without autograd and without training noise"""
    return (
        x.device.type in KERNEL_DEVICES and dtype == torch.bfloat16 and
        noise is None and not torch.is_grad_enabled())


def pack_weights(network):
    """The subframe network's weights and GRU biases in one bf16 tensor,
    in the order `csrc/fargan_subframe.cu` reads them: fwconv's Dense
    and GLU, each GRU's input and hidden projection and its GLU, the skip
    Dense and GLU, the output Dense (all (out, in) row-major), then each
    GRU's input and hidden bias"""
    grus, glus = network.grus, network.glus
    parts = [network.fwconv.dense.weight, network.fwconv.glu.dense.weight]
    for gru, glu in zip(grus, glus):
        parts += [gru.weight_ih, gru.weight_hh, glu.dense.weight]
    parts += [network.skip.weight, network.skip_glu.dense.weight,
              network.output.weight]
    for gru in grus:
        parts += [gru.bias_ih, gru.bias_hh]
    shapes = [tuple(part.shape) for part in parts]
    expected = [
        (HOPSIZE, 2 * STATE_WIDTHS[3]), (HOPSIZE, HOPSIZE)] + [
        (3 * HOPSIZE, HOPSIZE + 2 * SUBFRAME), (3 * HOPSIZE, HOPSIZE),
        (HOPSIZE, HOPSIZE)] * 3 + [
        (HOPSIZE, 4 * HOPSIZE + 2 * SUBFRAME), (HOPSIZE, HOPSIZE),
        (SUBFRAME, HOPSIZE)] + [(3 * HOPSIZE,)] * 6
    if shapes != expected:
        raise ValueError(
            f'K4 is built for hop {HOPSIZE} and subframes of {SUBFRAME}; '
            f'the network has {shapes}')
    if any(dense.bias is not None for dense in (
            network.skip, network.output, network.fwconv.dense)):
        raise ValueError('K4 takes dense layers without bias')
    with torch.no_grad():
        return torch.cat([
            part.detach().reshape(-1).to(torch.bfloat16) for part in parts])


class Slots:
    """The buffers of one frame loop on K4, a slot for every subframe's
    inputs and results

    Arguments
        cond: (B, frames, subframes, 2 * size) conditioning, in dtype
        index: (B, frames, size + 4) int64 lookback indices into a
            subframe's history window (`models.fargan.lookback_index`)
        previous: (B, history) float32 samples before the first subframe
        states: the four recurrent states carried into the first subframe
        dtype: the compute dtype

    `step(i)` gives subframe i's slots: its features, pitch lookback,
    previous subframe and states (a tuple of four), then its output and
    the states it returns (subframe i + 1's); `samples` is the float32
    history, the first `history` samples followed by each subframe's.
    """
    # Steps whose views are made at once
    CHUNK = 16

    def __init__(self, cond, index, previous, states, dtype):
        batch, frames, per_frame, width = cond.shape
        size = width // 2
        count = frames * per_frame
        history = previous.shape[-1]
        device = cond.device
        self.rows, self.count, self.per_frame = batch, count, per_frame
        self.size, self.history, self.index = size, history, index
        self.samples = torch.empty(
            (batch, history + count * size), dtype=torch.float32,
            device=device)
        self.samples[:, :history] = previous

        def slots(count, width):
            return torch.empty(
                (count, batch, width), dtype=dtype, device=device)

        # Subframe s of a frame, all rows: (count, B, 2 * size)
        self.buffers = {
            'features': cond.permute(1, 2, 0, 3).reshape(count, batch, width),
            'lookback': slots(count, size + 4),
            'previous': slots(count, size),
            'outputs': slots(count, size),
            'states': [slots(count + 1, state.shape[-1]) for state in states]}
        for slot, state in zip(self.buffers['states'], states):
            slot[0] = state
        # The views of a CHUNK of steps are made when the loop reaches
        # them, while the card runs the subframes before
        self.chunks = {}
        self.plan = None
        if count:
            self.feed(0)

    def step(self, step):
        """(features, lookback, previous, states, output, next states) of
        subframe `step`: the same tensors at every look-up"""
        chunk, at = divmod(step, self.CHUNK)
        rows = self.chunks.get(chunk)
        if rows is None:
            rows = self.chunks[chunk] = self._views(
                chunk * self.CHUNK, self.chunks.get(chunk - 1, (None,))[-1])
            # The chunk before stays: its last step's results are looked
            # up as this chunk's first inputs
            self.chunks.pop(chunk - 2, None)
        return rows[at]

    def _views(self, start, before=None):
        """The slots of the CHUNK steps from `start`; `before`, the row of
        the step before, gives the first step's states"""
        buffers = self.buffers
        end = min(start + self.CHUNK, self.count)
        parts = [buffers[name][start:end].unbind(0)
                 for name in ('features', 'lookback', 'previous', 'outputs')]
        states = list(zip(*(
            slot[start + (before is not None):end + 1].unbind(0)
            for slot in buffers['states'])))
        if before is not None:
            states.insert(0, before[5])
        return [(*inputs, states[i], output, states[i + 1])
                for i, (*inputs, output) in enumerate(zip(*parts))]

    def feed(self, step):
        """Fill subframe `step`'s pitch lookback and previous subframe from
        its window of the history, as each launch fills the next
        subframe's"""
        _, lookback, previous, *_ = self.step(step)
        start = step * self.size
        window = self.samples[:, start:start + self.history]
        lookback.copy_(torch.gather(
            window, 1, self.index[:, step // self.per_frame]))
        previous.copy_(window[:, -self.size:])

    def kernel_plan(self, network):
        """The C view of these slots with the network's packed weights,
        made at the first launch"""
        if self.plan is None:
            self.plan = _Plan(self, network.packed())
        return self.plan


class _FarganPlan(ctypes.Structure):
    """`FarganPlan` of `csrc/fargan_subframe.cu`"""
    _fields_ = [
        ('weights', ctypes.c_void_p),
        ('features', ctypes.c_void_p),
        ('outputs', ctypes.c_void_p),
        ('states', ctypes.c_void_p * 4),
        ('samples', ctypes.c_void_p),
        ('index', ctypes.c_void_p),
        ('lookback', ctypes.c_void_p),
        ('previous', ctypes.c_void_p),
        ('stream', ctypes.c_void_p),
        ('features_slot', ctypes.c_longlong),
        ('features_stride', ctypes.c_longlong),
        ('lookback_stride', ctypes.c_longlong),
        ('previous_stride', ctypes.c_longlong),
        ('state_stride', ctypes.c_longlong * 4),
        ('samples_stride', ctypes.c_longlong),
        ('index_stride', ctypes.c_longlong),
        ('rows', ctypes.c_int),
        ('subframes', ctypes.c_int),
        ('per_frame', ctypes.c_int),
        ('history', ctypes.c_int)]


class _Plan:
    """A `_FarganPlan` and the tensors it points into; `step` is the
    kernel's C entry point"""

    def __init__(self, slots, weights):
        buffers = slots.buffers
        device = slots.samples.device
        widths = tuple(slot.shape[-1] for slot in buffers['states'])
        if (slots.size, widths) != (SUBFRAME, STATE_WIDTHS):
            raise ValueError(
                f'K4 takes subframes of {SUBFRAME} and states {STATE_WIDTHS};'
                f' got {slots.size} and {widths}')
        if slots.history < SUBFRAME:
            raise ValueError('K4 needs a history of at least one subframe')
        index = slots.index.contiguous()
        for name, tensor in (('weights', weights),
                             ('outputs', buffers['outputs'])):
            if tensor.dtype != torch.bfloat16 or tensor.device != device:
                raise ValueError(
                    f'K4 takes bf16 {name} on {device}; got {tensor.dtype} '
                    f'on {tensor.device}')
        library = _library()
        if weights.numel() != library.fargan_subframe_packed():
            raise ValueError('K4 takes the weights of `pack_weights`')
        if index.dtype != torch.int64 or index.device != device:
            raise ValueError('K4 takes int64 lookback indices on its device')
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
        self.structure = _FarganPlan(
            weights.data_ptr(), buffers['features'].data_ptr(),
            buffers['outputs'].data_ptr(),
            (ctypes.c_void_p * 4)(*(
                slot.data_ptr() for slot in buffers['states'])),
            slots.samples.data_ptr(), index.data_ptr(),
            buffers['lookback'].data_ptr(), buffers['previous'].data_ptr(),
            stream, buffers['features'].stride(0),
            buffers['features'].stride(1), buffers['lookback'].stride(1),
            buffers['previous'].stride(1),
            (ctypes.c_longlong * 4)(*(
                slot.stride(1) for slot in buffers['states'])),
            slots.samples.stride(0), index.stride(0),
            slots.rows, slots.count, slots.per_frame, slots.history)
        self.pointer = ctypes.pointer(self.structure)
        self.tensors = (weights, index)
        self.step = library.fargan_subframe_step


def subframe(network, features, lookback, previous, states, slots, step):
    """Subframe `step` of the frame loop `slots` as one launch of K4

    Arguments as `models.fargan.SubframeNetwork.forward` takes them: the
    inputs are the slots' own for `step`, which the kernel reads itself.
    Returns the output and the new states, slots `step` and `step + 1` of
    `slots`.
    """
    own = slots.step(step)
    if not (features is own[0] and lookback is own[1] and
            previous is own[2] and states is own[3]):
        raise ValueError(
            f'K4 reads subframe {step}\'s inputs from its slots; the call '
            'was given other tensors')
    plan = slots.plan or slots.kernel_plan(network)
    status = plan.step(plan.pointer, step)
    if status:
        _build.check(status, 'fargan_subframe')
    subframe.launches += 1
    return own[4], own[5]


subframe.launches = 0


@functools.lru_cache(maxsize=None)
def _library():
    library = _build.library('fargan_subframe')
    library.fargan_subframe_packed.argtypes = []
    library.fargan_subframe_packed.restype = ctypes.c_longlong
    library.fargan_subframe_step.argtypes = [
        ctypes.POINTER(_FarganPlan), ctypes.c_int]
    library.fargan_subframe_step.restype = ctypes.c_int
    return library
