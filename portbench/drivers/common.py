"""What the drivers share: the models from the seed, the ranges around
the kernels' work, the requests' audio, the comparisons

The program's models are built by the port and filled with the
harness's weights (`weights.seeded_state`); the reference's models are
built by `reference.models` and loaded with the same state dicts.
"""
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .. import generate, harness, synthetic, weights
from ..harness import Window
from ..reference import models as reference_models


def seeded_states(modules, seed, device, config_file):
    """{name: state dict} of the named port modules, each from its own
    stream of `seed`; the generator's weights widened by the
    configuration file's `generator_weight_gain`"""
    streams = generate.subseeds(seed, len(modules))
    return {
        name: weights.seeded_state(
            module, stream, device,
            config_file['generator_weight_gain'] if name == 'generator'
            else 1.)
        for stream, (name, module) in zip(streams, sorted(modules.items()))}


def program_models(port, config, states, device):
    """The port's pitch CNN, PPG encoder and generator with `states`"""
    models = {
        'pitch': port.preprocess.PitchCNN(),
        'ppg': port.preprocess.PPGEncoder(),
        'generator': port.models.Generator(config)}
    return {name: weights.load(model.to(device), states[name]).eval()
            for name, model in models.items() if name in states}


def reference_model_set(config, states, precision, device):
    """The reference's models with `states`, in `precision`"""
    models = {
        'pitch': reference_models.PitchCNN(precision),
        'ppg': reference_models.PPGEncoder(precision),
        'generator': reference_models.Generator(config, precision)}
    out = {}
    for name, model in models.items():
        if name in states:
            model = model.to(device)
            model.load_state_dict(states[name])
            out[name] = model.eval()
    return out


class Ranges:
    """Host ranges around the kernels' work, by what the work is, never
    by a kernel's name: `k1` around each HiFi-GAN `Block` call (a forward
    hook pair), `k2` around each call of `ops.viterbi.decode` (a wrapper,
    opening no range when tracing is off). The wrapper also keeps the last
    decoded path, the kernel's own output, for the comparison."""

    def __init__(self, port, tracer, generator=None):
        import promonet_tpu_torch.ops.viterbi as viterbi
        self.viterbi, self.original = viterbi, viterbi.decode
        self.handles = []
        self.last_path = None
        original, ranges = self.original, self

        def decode(*args, **kwargs):
            with tracer.range('k2'):
                ranges.last_path = original(*args, **kwargs)
            return ranges.last_path

        decode.launches = original.launches
        viterbi.decode = decode
        if tracer.on and generator is not None:
            for module in generator.modules():
                if isinstance(module, port.models.hifigan.Block):
                    self._hook(module)

    def _hook(self, module):
        opened = []

        def enter(module, inputs):
            record = torch.profiler.record_function('portbench.k1')
            record.__enter__()
            opened.append(record)

        def leave(module, inputs, output):
            opened.pop().__exit__(None, None, None)

        self.handles.append(module.register_forward_pre_hook(enter))
        self.handles.append(module.register_forward_hook(leave))

    def close(self):
        self.viterbi.decode = self.original
        for handle in self.handles:
            handle.remove()


def audio_bank(bank, seed):
    """Formant speech from the seed: `utterances` utterances of about
    `seconds` each, each of its own speaker, as float32 numpy (T,)"""
    rng = np.random.default_rng(generate.subseeds(seed, 1)[0])
    return [
        synthetic.generate_aligned_utterance(
            rng, synthetic.sample_speaker(rng, index), bank['seconds'])[0][0]
        for index in range(bank['utterances'])]


def relative(value, reference):
    """||value - reference|| / ||reference||; inf where the shapes differ"""
    if tuple(value.shape) != tuple(reference.shape):
        return float('inf')
    value, reference = value.float(), reference.float()
    return float((value - reference).norm() /
                 torch.clamp(reference.norm(), min=1e-30))


def largest(value, reference):
    """max |value - reference|; inf where the shapes differ"""
    if tuple(value.shape) != tuple(reference.shape):
        return float('inf')
    if value.numel() == 0:
        return 0.
    return float((value.float() - reference.float()).abs().max())


def sample(records, count, seed, length):
    """`count` of the records, drawn from the seed, the longest (by
    `length`) always among them"""
    if not records:
        return []
    longest = max(range(len(records)), key=lambda i: length(records[i]))
    rest = [i for i in range(len(records)) if i != longest]
    rng = np.random.default_rng(generate.subseeds(seed, 2)[1])
    chosen = rng.choice(len(rest), size=min(count - 1, len(rest)),
                        replace=False)
    return [records[longest]] + [records[rest[i]] for i in sorted(chosen)]


@dataclasses.dataclass
class Steps:
    """Every call of FARGAN's subframe network in one synthesis, stacked
    in order, float32: its inputs (conditioning (N, 2 S), pitch lookback
    (N, S + 4), previous subframe (N, S), the four recurrent states) and
    its output subframes (N, S)"""
    inputs: tuple
    outputs: torch.Tensor


def capture(module, call):
    """(call(), `Steps` of `module`'s calls during it): a forward hook
    keeps each call's first four arguments and first output"""
    kept = []

    def hook(module, arguments, output):
        kept.append((arguments[:4], output[0]))

    handle = module.register_forward_hook(hook)
    try:
        with torch.no_grad():
            result = call()
    finally:
        handle.remove()

    def stack(values):
        return torch.cat([value.float() for value in values])

    inputs = tuple(stack(arguments[index] for arguments, _ in kept)
                   for index in range(3))
    states = [stack(arguments[3][index] for arguments, _ in kept)
              for index in range(4)]
    return result, Steps((*inputs, states), stack(
        output for _, output in kept))


def log_quarters(done, elapsed):
    """Log the audio seconds a second that each quarter of the window
    delivered, and the threads and cores the process had: whether a
    run's pace drifts inside its window or is set once per process"""
    rates, last = [], 0.
    for quarter in range(1, 5):
        total = max([output for at, output in done
                     if at <= quarter * elapsed / 4] or [0.])
        rates.append((total - last) / (elapsed / 4))
        last = total
    harness.log(
        'window quarters, audio-s/s: ' +
        ', '.join(f'{rate:.2f}' for rate in rates) +
        f'; torch threads {torch.get_num_threads()}, cores '
        f'{sorted(os.sched_getaffinity(0))}')


def closed_loop(tracer, requests, serve, seconds, delivered):
    """One client serves `requests` in turn until `seconds` have passed;
    the window ends when the last request is back

    delivered(request, answer): the seconds of audio an answer delivers.
    Returns a `Window` with `audio_s_per_s` and `request_p95_ms` (a
    failed request counts as infinitely late), the delivered seconds as
    work and the (request, answer) pairs as records.
    """
    latencies, records, failed, output, done = [], [], 0, 0., []
    with tracer.window():
        start = time.perf_counter()
        deadline = start + seconds
        index = 0
        while time.perf_counter() < deadline:
            request = requests[index % len(requests)]
            index += 1
            begin = time.perf_counter()
            try:
                with tracer.range('request'):
                    answer = serve(request)
            except Exception as error:  # a failed request is counted
                failed += 1
                latencies.append(math.inf)
                print(f'portbench: request failed: {error!r}', flush=True,
                      file=sys.stderr)
                continue
            latencies.append(time.perf_counter() - begin)
            output += delivered(request, answer)
            records.append((request, answer))
            done.append((time.perf_counter() - start, output))
        end = time.perf_counter()
    elapsed = end - start
    log_quarters(done, elapsed)
    return Window(
        index, failed, elapsed,
        {'audio_s_per_s': output / elapsed,
         'request_p95_ms': 1e3 * float(np.percentile(latencies, 95))},
        {'output_seconds': output}, records)
