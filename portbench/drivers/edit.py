"""The edit chain, one utterance a request, in a closed loop

Each request is audio cut from the bank of formant speech, with a pitch
shift, a time-stretch ratio, a loudness scale and a speaker, all from
the mix's laws (`generate`). The program serves it through
`preprocess.from_audio` → `edit.from_features` →
`synthesize.from_features`, which returns the audio to the host. One
client sends the next request when the last one is back.

End-to-end: `audio_s_per_s`, seconds of output audio over the window's
seconds, and `request_p95_ms`, the 95th percentile of every request's
latency (a failed request counts as infinite).

The comparison follows the program stage by stage: the reference
preprocesses the same audio, then edits the program's features and
synthesizes the program's edited features, and each stage's output of
the program is judged against the reference's.
"""
import dataclasses
import math
import time

import numpy as np
import torch

from .. import generate, harness
from ..reference import chain
from ..reference.precision import EXACT, FLOAT8, exact
from . import common


@dataclasses.dataclass
class Request:
    audio: np.ndarray        # (1, T) float32
    pitch_shift_cents: float
    time_stretch_ratio: float
    loudness_scale_db: float
    speaker: int
    hopsize: int

    @property
    def frames(self):
        return self.audio.shape[-1] // self.hopsize

    def out_frames(self):
        return int(round(self.frames / self.time_stretch_ratio))


@dataclasses.dataclass
class Served:
    features: tuple          # loudness, pitch, periodicity, ppg
    path: torch.Tensor       # the Viterbi decode's bins, padded frames
    edited: tuple
    audio: np.ndarray        # (1, samples)


def requests(traffic, seed, config):
    """The mix's requests: audio cut from the bank, edits from the laws"""
    bank = common.audio_bank(traffic['bank'], seed)
    laws = dict(traffic['laws'])
    laws['utterance'] = {'law': 'integers', 'count': len(bank)}
    values = generate.draw(laws, traffic['requests'], seed, config)
    out = []
    for i in range(traffic['requests']):
        utterance = bank[values['utterance'][i]]
        samples = int(values['seconds'][i] * config.SAMPLE_RATE)
        start = int(values['offset'][i] * (len(utterance) - samples))
        out.append(Request(
            utterance[start:start + samples][None].copy(),
            float(values['pitch_shift_cents'][i]),
            float(values['time_stretch_ratio'][i]),
            float(values['loudness_scale_db'][i]),
            int(values['speaker'][i]), config.HOPSIZE))
    return out


class Program:
    """The port's edit chain with the harness's weights"""

    def __init__(self, context, states):
        import promonet_tpu_torch as port
        self.port, self.config = port, context.config
        self.device, self.tracer = context.device, context.tracer
        self.models = common.program_models(
            port, self.config, states, self.device)
        self.ranges = common.Ranges(
            port, self.tracer, self.models['generator'])

    def serve(self, request):
        port, config, tracer = self.port, self.config, self.tracer
        with tracer.span('preprocess'):
            features = port.preprocess.from_audio(
                request.audio, self.models['pitch'], self.models['ppg'],
                config=config, device=self.device)
        path = self.ranges.last_path
        with tracer.range('edit'):
            edited = port.edit.from_features(
                *features, pitch_shift_cents=request.pitch_shift_cents,
                time_stretch_ratio=request.time_stretch_ratio,
                loudness_scale_db=request.loudness_scale_db, config=config)
        with tracer.span('synthesize'):
            audio = port.synthesize.from_features(
                *edited, generator=self.models['generator'],
                speaker=request.speaker, device=self.device)
        return Served(features, path, edited, audio)

    def rerun(self, request, served):
        """The synthesis of `served`'s edited features again, with every
        subframe's inputs and output kept (`common.capture`)"""
        generator = self.models['generator']
        return common.capture(
            generator.backbone.subframe,
            lambda: self.port.synthesize.from_features(
                *served.edited, generator=generator, speaker=request.speaker,
                device=self.device)[0])

    def close(self):
        self.ranges.close()
        self.models = None


class Control:
    """The reference in the program's place, in scaled float8"""

    def __init__(self, context, states):
        self.config, self.device = context.config, context.device
        self.models = common.reference_model_set(
            self.config, states, FLOAT8, self.device)

    def serve(self, request):
        config, models = self.config, self.models
        with exact():
            pre = chain.preprocess(
                torch.from_numpy(request.audio).to(self.device),
                models['pitch'], models['ppg'], config, FLOAT8)
            features = tuple(pre[name] for name in (
                'loudness', 'pitch', 'periodicity', 'ppg'))
            edited = chain.edit(
                *features, request.pitch_shift_cents,
                request.time_stretch_ratio, request.loudness_scale_db, config,
                FLOAT8)
            audio = chain.synthesize(
                models['generator'], *edited, request.speaker, config)
        return Served(features, pre['path'], edited,
                      audio.cpu().numpy()[None])

    def rerun(self, request, served):
        generator = self.models['generator']
        with exact():
            return common.capture(
                generator.backbone.subframe,
                lambda: chain.synthesize(
                    generator, *served.edited, request.speaker,
                    self.config).cpu().numpy())

    def close(self):
        self.models = None


@dataclasses.dataclass
class State:
    requests: list
    states: dict
    system: object


def setup(context):
    import promonet_tpu_torch as port
    config, traffic = context.config, context.cell.traffic
    modules = {
        'pitch': port.preprocess.PitchCNN(),
        'ppg': port.preprocess.PPGEncoder(),
        'generator': port.models.Generator(config)}
    states = common.seeded_states(
        modules, context.seed, context.device, context.cell.config_file)
    system = (Program if context.system == 'program' else Control)(
        context, states)
    started = time.perf_counter()
    served = requests(traffic, context.seed, config)
    made = time.perf_counter()
    warm_up(system, served, traffic['warmup'], config)
    harness.log(f'requests made in {made - started:.3f} s, warm-up '
                f'{time.perf_counter() - made:.3f} s')
    return State(served, states, system)


def warm_up(system, served, mode, config):
    """Serve every request once ('requests'), or ('buckets') preprocess
    one request of each input bucket and serve the shortest request
    whole: the frame loop's shapes do not depend on the length"""
    if mode == 'requests':
        for request in served:
            system.serve(request)
        return
    buckets = {}
    for request in served:
        bucket = chain.bucket_frames(
            request.frames, config.INFERENCE_FRAME_BUCKETS)
        buckets.setdefault(bucket, request)
    if isinstance(system, Program):
        for request in buckets.values():
            system.port.preprocess.from_audio(
                request.audio, system.models['pitch'], system.models['ppg'],
                config=config, device=system.device)
    system.serve(min(served, key=lambda request: request.frames))


def run(context, state, seconds):
    rate = context.config.SAMPLE_RATE
    window = common.closed_loop(
        context.tracer, state.requests, state.system.serve, seconds,
        lambda request, served: served.audio.shape[-1] / rate)
    window.work.update(
        preprocess_frames=[request.frames for request, _ in window.records],
        generator_calls=[[request.out_frames()]
                         for request, _ in window.records])
    return window


def check(context, state, window):
    """The numbers compared, each the largest over the sampled requests"""
    config, traffic = context.config, context.cell.traffic
    checked = common.sample(
        window.records, traffic['checked'], context.seed,
        lambda record: record[0].out_frames())
    # FARGAN is judged one subframe at a time from the program's own
    # state, which a second run of the same synthesis records
    reruns = [state.system.rerun(request, served)
              if config.MODEL == 'fargan' else None
              for request, served in checked]
    state.system.close()
    state.system = None
    if context.device.type == 'cuda':
        torch.cuda.empty_cache()
    models = common.reference_model_set(
        config, state.states, EXACT, context.device)
    numbers = {}
    for (request, served), rerun in zip(checked, reruns):
        for name, value in judge(request, served, rerun, models, config,
                                 context.device).items():
            numbers[name] = max(numbers.get(name, 0.), value)
    return numbers


def judge(request, served, rerun, models, config, device):
    """The program's answer to one request against the reference

    The decoded pitch path is judged by how far its log-probability under
    the reference's observations lies below the reference's best path
    (`pitch_path_nats`): near-ties may go either way under rounding. The
    pitch and periodicity are judged at the program's own path."""
    with exact():
        ref = chain.preprocess(
            torch.from_numpy(request.audio).to(device), models['pitch'],
            models['ppg'], config, EXACT)
        frames = request.frames
        loudness, pitch, periodicity, ppg = served.features
        numbers = {
            'loudness_db': common.largest(loudness, ref['loudness']),
            'ppg': common.largest(ppg, ref['ppg'])}
        path = served.path.to(device).long()
        if path.shape != ref['path'].shape:
            numbers.update(pitch_path_nats=math.inf, pitch_cents=math.inf,
                           periodicity=math.inf)
        else:
            numbers['pitch_path_nats'] = max(0., chain.path_score(
                ref['observation'], ref['path']) - chain.path_score(
                    ref['observation'], path))
            at_path, periodicity_at_path = chain.refine(
                ref['logits'], path, config)
            numbers['pitch_cents'] = cents(pitch, at_path[None, :frames])
            numbers['periodicity'] = common.largest(
                periodicity, periodicity_at_path[None, :frames])
        edited = chain.edit(
            *served.features, request.pitch_shift_cents,
            request.time_stretch_ratio, request.loudness_scale_db, config,
            EXACT)
        numbers['edit'] = max(
            common.largest(value, reference) / max(
                float(reference.abs().max()), 1e-30)
            for value, reference in zip(served.edited, edited))
        output = torch.from_numpy(served.audio[0]).to(device)
        generator = models['generator']
        if rerun is None:
            numbers['audio'] = common.relative(output, chain.synthesize(
                generator, *served.edited, request.speaker, config))
            return numbers
        audio, steps = rerun
        conditioning, lookback = chain.fargan_inputs(
            generator, *served.edited, request.speaker, config)
        numbers['conditioning'] = common.relative(
            steps.inputs[0], conditioning)
        numbers.update(frame_loop(
            generator.backbone, steps, lookback, output))
        if not torch.equal(torch.as_tensor(audio).to(device), output):
            # The second run must be the timed computation itself
            numbers['audio'] = math.inf
    return numbers


def frame_loop(backbone, steps, lookback, output):
    """FARGAN's frame loop held to the reference one subframe at a time,
    from the program's own state (`common.Steps`)

    history: the largest gap between the pitch lookback and the previous
        subframe that the program fed each subframe and those that the
        reference reads, at its own pitch periods (`lookback`, the
        reference's indices into a subframe's history), from the
        program's earlier outputs; an exact comparison
    states: the recurrent states that the program carried into each
        subframe against those that the reference's subframe returns from
        the program's inputs to the one before (zeros before the first):
        the worst state's relative gap
    audio: every subframe's output against the reference's from the same
        inputs, relative; infinite unless the program's audio is its
        subframes' outputs in order
    """
    size, history = backbone.subframe_size, backbone.num_previous
    outputs = steps.outputs
    count = outputs.shape[0]
    if lookback.shape[0] != count:
        return dict.fromkeys(('history', 'states', 'audio'), math.inf)
    samples = torch.cat((outputs.new_zeros(history), outputs.reshape(-1)))
    starts = size * torch.arange(count, device=outputs.device)[:, None]
    previous = starts + history - size + torch.arange(
        size, device=outputs.device)
    fed = max(common.largest(steps.inputs[1], samples[starts + lookback]),
              common.largest(steps.inputs[2], samples[previous]))
    returned, carried = backbone.subframe(*steps.inputs)
    states = max(
        common.relative(state, torch.cat((torch.zeros_like(
            reference[:1]), reference[:-1])))
        for state, reference in zip(steps.inputs[3], carried))
    audio = common.relative(outputs, returned)
    delivered = output.reshape(-1)
    if not torch.equal(outputs.reshape(-1)[:delivered.numel()], delivered):
        audio = math.inf
    return {'history': fed, 'states': states, 'audio': audio}


def cents(value, reference):
    """Largest |1200 log2(value / reference)|; inf where shapes differ"""
    if tuple(value.shape) != tuple(reference.shape):
        return math.inf
    return float((1200 * torch.log2(value / reference)).abs().max())
