"""Batched synthesis of cached features, in a closed loop

Each request is `batch` feature sets of one frame bucket, as a corpus
resynthesis job sends them: pitch contours, periodicity, loudness and
PPGs made by the harness from the seed on the device (not by the port),
with true lengths spread evenly over the bucket. The program serves it
through `synthesize.from_features_batched` (one generator call of
`batch` rows) and the audio is copied to the host. One client sends the
next request when the last one is back.

End-to-end: `audio_s_per_s` over the rows' true lengths, and
`request_p95_ms`. The comparison synthesizes the same feature sets with
the reference and judges each row's audio over its true length.
"""
import dataclasses
import math

import torch

from .. import generate
from ..reference import chain
from ..reference.precision import EXACT, FLOAT8, exact
from . import common


@dataclasses.dataclass
class Request:
    sets: list               # [(loudness, pitch, periodicity, ppg)] on device
    frames: list             # true frames of each set
    speakers: list
    bucket: int


def contour(generator, count, frames, knots, device):
    """`count` smooth random contours (count, frames): standard normal
    values at `knots` points, linearly interpolated"""
    values = torch.randn((count, 1, knots), generator=generator,
                         device=device)
    return torch.nn.functional.interpolate(
        values, size=frames, mode='linear', align_corners=True)[:, 0]


def feature_sets(generator, frames_list, config, device):
    """One feature set per entry of `frames_list`, made on the device:
    pitch around a per-set base of 90-250 Hz moving up to half an octave,
    periodicity in (0, 1), loudness of LOUDNESS_BANDS bands around
    -40 dB, and a PPG, a softmax over PPG_CHANNELS per frame"""
    sets = []
    for frames in frames_list:
        knots = max(2, frames // 16)
        base = 90. + 160. * torch.rand((1, 1), generator=generator,
                                       device=device)
        pitch = base * 2 ** (0.25 * torch.tanh(
            contour(generator, 1, frames, knots, device)))
        periodicity = torch.sigmoid(
            2 * contour(generator, 1, frames, knots, device))
        loudness = -40. + 15. * contour(
            generator, config.LOUDNESS_BANDS, frames, knots, device)
        ppg = torch.softmax(3. * contour(
            generator, config.PPG_CHANNELS, frames, knots, device), dim=0)
        sets.append((loudness, pitch, periodicity, ppg))
    return sets


def requests(traffic, seed, config, device):
    """The mix's requests. Each takes its bucket from a length of the
    `seconds` law; its sets' true lengths lie evenly spread over the
    bucket (above the bucket below it)"""
    count, batch = traffic['requests'], traffic['batch']
    values = generate.draw(traffic['laws'], count, seed, config)
    buckets = config.INFERENCE_FRAME_BUCKETS
    generator = torch.Generator(device=device).manual_seed(
        generate.subseeds(seed, 3)[2])
    out = []
    for i in range(count):
        frames = int(values['seconds'][i] * config.SAMPLE_RATE) // \
            config.HOPSIZE
        bucket = chain.bucket_frames(frames, buckets)
        below = max([b for b in buckets if b < bucket], default=0)
        lengths = [below + math.ceil((bucket - below) * (j + 0.5) / batch)
                   for j in range(batch)]
        speakers = generate.draw(
            {'speaker': traffic['laws']['speaker']}, batch, seed + i,
            config)['speaker']
        out.append(Request(
            feature_sets(generator, lengths, config, device), lengths,
            [int(speaker) for speaker in speakers], bucket))
    return out


class Program:
    """The port's batched synthesis with the harness's weights"""

    def __init__(self, context, states):
        import promonet_tpu_torch as port
        self.port, self.config = port, context.config
        self.device, self.tracer = context.device, context.tracer
        self.batch = context.cell.traffic['batch']
        self.models = common.program_models(
            port, self.config, states, self.device)
        self.ranges = common.Ranges(
            port, self.tracer, self.models['generator'])

    def serve(self, request):
        with self.tracer.span('synthesize'):
            audio = self.port.synthesize.from_features_batched(
                request.sets, self.models['generator'],
                speakers=request.speakers, batch_size=self.batch,
                device=self.device)
        return audio[:, 0].cpu()

    def close(self):
        self.ranges.close()
        self.models = None


class Control:
    """The reference in the program's place, in scaled float8"""

    def __init__(self, context, states):
        self.config, self.device = context.config, context.device
        self.batch = context.cell.traffic['batch']
        self.models = common.reference_model_set(
            self.config, states, FLOAT8, self.device)

    def serve(self, request):
        with exact():
            return chain.synthesize_batched(
                self.models['generator'], request.sets, request.speakers,
                self.config, self.batch).cpu()

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
    states = common.seeded_states(
        {'generator': port.models.Generator(config)}, context.seed,
        context.device, context.cell.config_file)
    system = (Program if context.system == 'program' else Control)(
        context, states)
    served = requests(traffic, context.seed, config, context.device)
    warmed = set()
    for request in served:
        if request.bucket not in warmed:
            system.serve(request)
            warmed.add(request.bucket)
    return State(served, states, system)


def run(context, state, seconds):
    config = context.config
    window = common.closed_loop(
        context.tracer, state.requests, state.system.serve, seconds,
        lambda request, audio: sum(request.frames) * config.HOPSIZE /
        config.SAMPLE_RATE)
    window.work['generator_calls'] = [
        request.frames for request, _ in window.records]
    return window


def check(context, state, window):
    """`audio`: the largest relative error of a row's audio over its true
    length, over the sampled requests"""
    config, traffic = context.config, context.cell.traffic
    state.system.close()
    state.system = None
    if context.device.type == 'cuda':
        torch.cuda.empty_cache()
    generator = common.reference_model_set(
        config, state.states, EXACT, context.device)['generator']
    checked = common.sample(
        window.records, traffic['checked'], context.seed,
        lambda record: record[0].bucket)
    worst = 0.
    for request, audio in checked:
        with exact():
            reference = chain.synthesize_batched(
                generator, request.sets, request.speakers, config,
                traffic['batch'])
        if tuple(audio.shape) != tuple(reference.shape):
            return {'audio': math.inf}
        for row, frames in enumerate(request.frames):
            samples = frames * config.HOPSIZE
            worst = max(worst, common.relative(
                audio[row, :samples].to(context.device),
                reference[row, :samples]))
    return {'audio': worst}
