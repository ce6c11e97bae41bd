"""FARGAN vocoder backbone (counterpart of `promonet_tpu/models/fargan.py`)

A framewise autoregressive vocoder: a conditioning network over all
frames at once, then a loop over frames and, inside each, over the
subframes, each of which reads one or two pitch periods back in the
samples it has made so far. The JAX package runs the frame loop as one
`nn.scan`; here it is a Python loop on the device, a few tens of small
operations per subframe.

Rounding follows the JAX package: the conditioning, the recurrent states
and every layer compute in the generator's dtype, while the sample
history is float32 and each subframe's samples are rounded to the dtype
and widened back into it.

Two routes run the frame loop. Inference writes each subframe into one
preallocated sample buffer; where its input lies on a CUDA device, in
bf16, without autograd or noise (`ops.fargan.uses_kernel`), each
subframe is one launch of kernel K4, the loop's buffers in an
`ops.fargan.Slots`, and any other runs the plain PyTorch subframe. The
loop is the span `frame_loop` (`utils.timer.span`), which counts the rows
times the subframes it ran (`subframes`), those K4 ran (`fused`, from its
launches) and the rows (`rows`). Training (`train=True`) keeps every
subframe's output and rolls the history by concatenation, as the JAX
package's scan does, so that autograd can run back through it; it also
takes the additive training noise (`additive_noise`) from a noise source
the caller passes, eleven draws per subframe in the JAX package's order.
"""
import itertools
import math

import torch
from torch import nn

from ..ops import fargan as kernel
from ..utils import timer
from .modules import Dense, cast


# Noise draws per subframe on the training route: the conditioning slice,
# the previous subframe, the pitch lookback, the framewise conv's output,
# each GRU's state into its GLU and that GLU's output, the skip path's tanh
NOISE_SITES = 11


def additive_noise(x, noise):
    """clip(x + (u - .5) / 127, -1, 1), the JAX package's training noise

    `noise(x)` gives u, uniform on [0, 1) in x's shape and dtype; the
    arithmetic runs in x's dtype, as `promonet_tpu/models/fargan.py:19-25`
    does it.
    """
    return torch.clamp(x + (1. / 127.) * (noise(x) - .5), -1., 1.)


class Uniform:
    """The default noise source: uniform draws from a `torch.Generator`

    The generator lies on the device of the tensors it is asked for.
    """

    def __init__(self, generator):
        self.generator = generator

    def __call__(self, x):
        return torch.rand(
            x.shape, dtype=x.dtype, device=x.device,
            generator=self.generator)


def lookback_index(period, history, subframe_size):
    """Where a subframe's pitch lookback reads in its sample history

    Arguments
        period: (...) integer pitch periods in samples
        history: length of the sample history
    Returns
        (..., subframe_size + 4) indices: subframe_size + 4 samples
        starting two before one period back, from two periods back where
        one period back would run past the history's end, as
        `promonet_tpu/models/fargan.py:137-142` builds them
    """
    index = history - period[..., None] + torch.arange(
        subframe_size + 4, device=period.device) - 2
    index = index - period[..., None] * (index >= history)
    return torch.clamp(index, 0, history - 1)


class GRUCellNoBias(nn.Module):
    """The JAX package's GRU cell over (B, in) inputs and (B, H) states

    Its input projection subtracts 1 / sqrt(H) from every gate on every
    call (`promonet_tpu/models/fargan.py:47`), so here it has a constant
    input bias of -1 / sqrt(H) and no hidden bias: the `n` gate is
    tanh(W_in x - b + r * W_hn h). Weights are (3H, in) and (3H, H) with
    the gates in the order r, z, n, PyTorch's layout. The biases are
    buffers, not weights: no state dict carries them.
    """

    def __init__(self, in_features, hidden):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.register_buffer('bias_ih', torch.full(
            (3 * hidden,), -1. / math.sqrt(hidden)), persistent=False)
        self.register_buffer(
            'bias_hh', torch.zeros(3 * hidden), persistent=False)
        self._casts = {}

    def forward(self, state, x, dtype=torch.float32):
        return torch.gru_cell(
            x.to(dtype), state,
            *(cast(self, name, dtype) for name in (
                'weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')))


class GLU(nn.Module):
    """x * sigmoid(Dense(x)), the Dense weight-normed"""

    def __init__(self, features):
        super().__init__()
        self.dense = Dense(features, features, weight_norm=True)

    def forward(self, x, dtype=torch.float32):
        return x * torch.sigmoid(self.dense(x, dtype))


class FramewiseConv(nn.Module):
    """tanh(Dense([features, state])) through a GLU; the Dense is
    weight-normed"""

    def __init__(self, in_features, features):
        super().__init__()
        self.dense = Dense(2 * in_features, features, weight_norm=True)
        self.glu = GLU(features)

    def forward(self, features, state, dtype=torch.float32):
        x = torch.tanh(self.dense(torch.cat((features, state), -1), dtype))
        return self.glu(x, dtype)


class ConditioningNetwork(nn.Module):
    """Three dense layers without bias, each followed by tanh"""

    def __init__(self, channels, hopsize):
        super().__init__()
        self.layers = nn.ModuleList([
            Dense(channels, channels), Dense(channels, channels),
            Dense(channels, 2 * hopsize)])

    def forward(self, x, dtype=torch.float32):
        for layer in self.layers:
            x = torch.tanh(layer(x, dtype))
        return x


class SubframeNetwork(nn.Module):
    """One subframe of samples from conditioning, lookback and recurrence"""

    def __init__(self, hopsize, subframe_size):
        super().__init__()
        # Conditioning slice, previous subframe and lookback
        self.fwconv = FramewiseConv(4 * subframe_size + 4, hopsize)
        gru_inputs = hopsize + 2 * subframe_size
        self.grus = nn.ModuleList(
            GRUCellNoBias(gru_inputs, hopsize) for _ in range(3))
        self.glus = nn.ModuleList(GLU(hopsize) for _ in range(3))
        self.skip = Dense(4 * hopsize + 2 * subframe_size, hopsize)
        self.skip_glu = GLU(hopsize)
        self.output = Dense(hopsize, subframe_size)
        self._packed = None

    def packed(self):
        """The weights packed for K4 (`ops.fargan.pack_weights`), made
        once and again when a parameter was written to or moved"""
        key = tuple(
            (tensor.device, tensor.data_ptr(), tensor._version)
            for tensor in itertools.chain(self.parameters(), self.buffers()))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, kernel.pack_weights(self))
        return self._packed[1]

    def forward(
        self, features, pitch_lookback, previous_subframe, states,
        dtype=torch.float32, noise=None, slots=None, step=None
    ):
        """
        Arguments
            features: (B, 2 * subframe_size) conditioning slice, in dtype
            pitch_lookback: (B, subframe_size + 4) samples a pitch period
                back, in dtype
            previous_subframe: (B, subframe_size) last samples, in dtype
            states: (gru1, gru2, gru3, fwconv) recurrent states, in dtype
            noise: None, or the training noise's source (`additive_noise`),
                drawn NOISE_SITES times in the JAX package's order
            slots, step: K4's frame loop (`ops.fargan.Slots`) and this
                subframe's index in it: the call is one launch of K4,
                which reads its inputs from their slots and writes its
                results into theirs, with the next subframe's inputs

        Returns
            (signal (B, subframe_size) in dtype, states): the GRU states
            are carried without noise, the subframe's input with it
        """
        if slots is not None:
            return kernel.subframe(
                self, features, pitch_lookback, previous_subframe, states,
                slots, step)
        return self.plain(
            features, pitch_lookback, previous_subframe, states, dtype, noise)

    def plain(
        self, features, pitch_lookback, previous_subframe, states, dtype,
        noise
    ):
        """The subframe in PyTorch operations (`forward`'s arguments)"""
        def noisy(x):
            return x if noise is None else additive_noise(x, noise)

        features = noisy(features)
        previous_subframe = noisy(previous_subframe)
        pitch_lookback = noisy(pitch_lookback)
        subframe_input = torch.cat(
            (features, previous_subframe, pitch_lookback), -1)
        fwconv_out = noisy(self.fwconv(subframe_input, states[3], dtype))
        # Without gain normalisation the JAX package's pitch gains are
        # ones, and multiplying by one changes nothing
        pitch_lookback = pitch_lookback[:, 2:-2]
        gru_outs, gru_states = [], []
        gru_in = fwconv_out
        for gru, glu, state in zip(self.grus, self.glus, states):
            state = gru(
                state,
                torch.cat((gru_in, pitch_lookback, previous_subframe), -1),
                dtype)
            gru_in = noisy(glu(noisy(state), dtype))
            gru_states.append(state)
            gru_outs.append(gru_in)
        skip = torch.cat(
            gru_outs + [fwconv_out, pitch_lookback, previous_subframe], -1)
        skip = self.skip_glu(noisy(torch.tanh(self.skip(skip, dtype))), dtype)
        output = torch.tanh(self.output(skip, dtype))
        return output, (*gru_states, subframe_input)


class FARGAN(nn.Module):
    """(B, T, C) features, the last channel the pitch period in samples →
    (B, T * hopsize, 1) float32 audio

    The JAX package builds FARGAN with its class defaults whatever the
    configuration says (hop 256, 4 subframes of 64, no gain
    normalisation); so does the port. Its history of 2 frames is also
    the width of the JAX streamer's carry, `NUM_PREVIOUS_SAMPLES`; here
    the generator passes that setting as `num_previous`, so model and
    carry agree by construction (512 samples in every shipped config).
    """

    def __init__(
        self, num_features, global_channels, hopsize=256, subframe_size=64,
        subframes=4, num_previous=512
    ):
        super().__init__()
        self.hopsize = hopsize
        self.subframe_size = subframe_size
        self.subframes = subframes
        self.num_previous = num_previous
        self.conditioning = ConditioningNetwork(
            num_features - 1 + global_channels, hopsize)
        self.subframe = SubframeNetwork(hopsize, subframe_size)

    def initial_states(self, batch, dtype, device):
        """The zero carry: (sample history, recurrent states)"""
        def zeros(width, dtype=dtype):
            return torch.zeros((batch, width), dtype=dtype, device=device)

        return (
            zeros(self.num_previous, torch.float32),
            (zeros(self.hopsize), zeros(self.hopsize), zeros(self.hopsize),
             zeros(4 * self.subframe_size + 4)))

    def forward(
        self, features, global_features, dtype=torch.float32,
        initial_states=None, return_states=False, previous_samples=None,
        train=False, noise=None
    ):
        """
        Arguments
            features: (B, T, C) in dtype
            global_features: (B, 1, G) in dtype
            initial_states: (sample history (B, 2 * hopsize) float32,
                recurrent states) carried from an earlier call, whose
                frames this call continues; None starts from zeros
            return_states: also return the final carry
            previous_samples: (B, 1, S) audio before the first frame,
                whose last num_previous samples start the history (zeros
                where there is none); read when initial_states is None
            train: the training route, which autograd can run back
                through (see the module)
            noise: the training noise's source, a callable giving
                uniform [0, 1) draws in its argument's shape and dtype
                (`Uniform`); None adds no noise. Read only with train

        Returns
            audio (B, T * hopsize, 1) float32 [, final carry]
        """
        batch, frames, _ = features.shape
        size = self.subframe_size
        period = torch.round(features[..., -1]).long()
        period = torch.clamp(period, 1, self.num_previous - size - 2)
        cond = self.conditioning(
            torch.cat((
                features[..., :-1],
                global_features.expand(batch, frames, -1)), -1),
            dtype)
        # Subframe s of a frame takes every subframes-th value from s on
        cond = cond.reshape(batch, frames, 2 * size, self.subframes)
        cond = cond.transpose(2, 3).contiguous()

        history = self.num_previous
        lookback = lookback_index(period, history, size)

        if initial_states is None:
            initial_states = self.initial_states(
                batch, dtype, features.device)
            if previous_samples is not None:
                initial_states = (
                    previous_samples.reshape(batch, -1)[:, -history:].float(),
                    initial_states[1])
        previous, states = initial_states
        if train:
            return self._train_loop(
                cond, lookback, previous, states, dtype, noise,
                return_states)
        loop = (self._kernel_loop if kernel.uses_kernel(cond, dtype)
                else self._plain_loop)
        with timer.span(
                'frame_loop', subframes=frames * self.subframes * batch,
                rows=batch, fused=0) as counts:
            launches = kernel.subframe.launches
            samples, states = loop(cond, lookback, previous, states, dtype)
            if counts is not None:
                counts['fused'] = (kernel.subframe.launches - launches) * batch
        audio = samples[:, history:, None]
        if return_states:
            return audio, (samples[:, -history:], states)
        return audio

    def _plain_loop(self, cond, lookback, previous, states, dtype):
        """The inference loop in PyTorch operations: (samples, states)"""
        batch, frames = cond.shape[:2]
        size, history = self.subframe_size, self.num_previous
        # The history of subframe i is samples[:, i * size:][:, :history]
        samples = torch.empty(
            (batch, history + frames * self.hopsize), dtype=torch.float32,
            device=cond.device)
        samples[:, :history] = previous
        for frame in range(frames):
            index = lookback[:, frame]
            for subframe in range(self.subframes):
                start = (frame * self.subframes + subframe) * size
                window = samples[:, start:start + history]
                output, states = self.subframe(
                    cond[:, frame, subframe],
                    torch.gather(window, 1, index).to(dtype),
                    window[:, -size:].to(dtype),
                    states,
                    dtype)
                samples[:, start + history:start + history + size] = output
        return samples, states

    def _kernel_loop(self, cond, lookback, previous, states, dtype):
        """The inference loop as K4 launches, one a subframe: (samples,
        states)"""
        slots = kernel.Slots(cond, lookback, previous, states, dtype)
        if slots.count:
            states = slots.step(0)[3]
        for step in range(slots.count):
            row = slots.step(step)
            _, states = self.subframe(
                row[0], row[1], row[2], states, dtype, None, slots, step)
        return slots.samples, states

    def _train_loop(
        self, cond, lookback, previous, states, dtype, noise, return_states
    ):
        """The frame loop of the training route: each subframe's output
        kept, the history rolled by concatenation"""
        size = self.subframe_size
        outputs = []
        for frame in range(cond.shape[1]):
            index = lookback[:, frame]
            for subframe in range(self.subframes):
                output, states = self.subframe(
                    cond[:, frame, subframe],
                    torch.gather(previous, 1, index).to(dtype),
                    previous[:, -size:].to(dtype),
                    states,
                    dtype,
                    noise)
                outputs.append(output)
                previous = torch.cat((previous[:, size:], output.float()), -1)
        audio = torch.cat(outputs, -1).float()[..., None]
        if return_states:
            return audio, (previous, states)
        return audio
