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
and widened back into it. Inference only: the additive noise of training
is not ported.
"""
import math

import torch
from torch import nn

from .modules import Dense, cast


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
    """x * sigmoid(Dense(x)), the Dense weight-normed in the JAX package"""

    def __init__(self, features):
        super().__init__()
        self.dense = Dense(features, features)

    def forward(self, x, dtype=torch.float32):
        return x * torch.sigmoid(self.dense(x, dtype))


class FramewiseConv(nn.Module):
    """tanh(Dense([features, state])) through a GLU; the Dense is
    weight-normed in the JAX package"""

    def __init__(self, in_features, features):
        super().__init__()
        self.dense = Dense(2 * in_features, features)
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

    def forward(
        self, features, pitch_lookback, previous_subframe, states,
        dtype=torch.float32
    ):
        """
        Arguments
            features: (B, 2 * subframe_size) conditioning slice, in dtype
            pitch_lookback: (B, subframe_size + 4) samples a pitch period
                back, in dtype
            previous_subframe: (B, subframe_size) last samples, in dtype
            states: (gru1, gru2, gru3, fwconv) recurrent states, in dtype

        Returns
            (signal (B, subframe_size) in dtype, states)
        """
        subframe_input = torch.cat(
            (features, previous_subframe, pitch_lookback), -1)
        fwconv_out = self.fwconv(subframe_input, states[3], dtype)
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
            gru_in = glu(state, dtype)
            gru_states.append(state)
            gru_outs.append(gru_in)
        skip = torch.cat(
            gru_outs + [fwconv_out, pitch_lookback, previous_subframe], -1)
        skip = self.skip_glu(torch.tanh(self.skip(skip, dtype)), dtype)
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
        initial_states=None, return_states=False
    ):
        """
        Arguments
            features: (B, T, C) in dtype
            global_features: (B, 1, G) in dtype
            initial_states: (sample history (B, 2 * hopsize) float32,
                recurrent states) carried from an earlier call, whose
                frames this call continues; None starts from zeros
            return_states: also return the final carry

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
        previous, states = initial_states
        # The history of subframe i is samples[:, i * size:][:, :history]
        samples = torch.empty(
            (batch, history + frames * self.hopsize), dtype=torch.float32,
            device=features.device)
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
        audio = samples[:, history:, None]
        if return_states:
            return audio, (samples[:, -history:], states)
        return audio
