"""Zero-shot editing: each request brings its target speaker's reference
clip, one request at a time, in a closed loop

Each request is a source utterance cut from the bank of formant speech,
with a pitch shift, a time-stretch ratio and a loudness scale from the
mix's laws, as in `edit`, and a reference clip cut from another speaker
of the bank, of its own length. The program serves it through
`preprocess.speaker.from_audio` (WavLM-Base+ x-vectors, no x-vector kept
between requests) → `preprocess.from_audio` → `edit.from_features` →
`synthesize.from_features(speaker=<x-vector>)` under ZERO_SHOT. One
client sends the next request when the last one is back.

End-to-end: `audio_s_per_s` (seconds of output audio over the window's
seconds) and `request_p95_ms`, as in `edit`.

The comparison follows the program stage by stage: `speaker`, the
relative L2 of the program's x-vector before its normalisation against
the reference's (`reference.wavlm`) from the same 16 kHz audio the
program resampled; then every number of `edit.judge`, the synthesis
judged against the reference's synthesis of the program's edited
features with the program's x-vector.

WavLM's weights are drawn from the seed by the law a fresh
`transformers.WavLMForXVector` starts from (`wavlm_state`); the widths
are the configuration file's `wavlm` entry.
"""
import dataclasses
import math
import time

import numpy as np
import scipy.signal
import torch

from .. import generate, harness, weights
from ..reference import wavlm as reference_wavlm
from ..reference.precision import EXACT, FLOAT8, exact
from . import common, edit

WAVLM_RATE = 16000


@dataclasses.dataclass
class Request(edit.Request):
    # The target speaker's clip (1, R) at SAMPLE_RATE; `speaker` is unused
    reference: np.ndarray = None


@dataclasses.dataclass
class Served(edit.Served):
    xvector: torch.Tensor = None     # (512,) unit norm, what synthesis took
    raw: torch.Tensor = None         # (512,) before the normalisation
    samples: int = 0                 # of the 16 kHz audio WavLM read


def requests(traffic, seed, config):
    """The mix's requests: sources and references cut from the bank, the
    reference from another speaker than its source"""
    bank = common.audio_bank(traffic['bank'], seed)
    laws = dict(traffic['laws'])
    laws['utterance'] = {'law': 'integers', 'count': len(bank)}
    laws['other'] = {'law': 'integers', 'count': len(bank) - 1}
    values = generate.draw(laws, traffic['requests'], seed, config)
    rate = config.SAMPLE_RATE

    def cut(utterance, seconds, offset):
        samples = int(seconds * rate)
        start = int(offset * (len(utterance) - samples))
        return utterance[start:start + samples][None].copy()

    out = []
    for i in range(traffic['requests']):
        source = int(values['utterance'][i])
        target = (source + 1 + int(values['other'][i])) % len(bank)
        out.append(Request(
            cut(bank[source], values['seconds'][i], values['offset'][i]),
            float(values['pitch_shift_cents'][i]),
            float(values['time_stretch_ratio'][i]),
            float(values['loudness_scale_db'][i]), 0, config.HOPSIZE,
            cut(bank[target], values['reference_seconds'][i],
                values['reference_offset'][i])))
    return out


def wavlm_model(port, sizes, dtype=torch.float32):
    """The port's WavLMXVector at the configuration file's widths"""
    return port.models.wavlm.WavLMXVector(**sizes, dtype=dtype)


def wavlm_state(model, seed, device):
    """{parameter name: float32 tensor on `device`} drawn from `seed` by
    the law of `transformers`' `WavLMPreTrainedModel._init_weights`: dense
    layers normal with standard deviation 0.02 and zero bias, the
    feature projection uniform in ±1/sqrt(fan_in), the feature
    convolutions Kaiming-normal, the positional convolution normal with
    standard deviation 2/sqrt(kernel x channels) (g at the norm of v,
    zero bias), norms at (1, 0), the bucket embedding standard normal,
    the gates' constants at 1 and the layer weights equal. All normal
    draws come from one `torch.randn` call and all uniform draws from one
    `torch.rand` call of a generator on the device."""
    entries = []
    for prefix, module in model.named_modules():
        for name, parameter in module.named_parameters(recurse=False):
            full = f'{prefix}.{name}' if prefix else name
            entries.append((full, parameter.shape, _law(module, full, name)))
    generator = torch.Generator(device=device).manual_seed(seed)
    counts = {kind: sum(math.prod(shape) for _, shape, law in entries
                        if law[0] == kind) for kind in ('normal', 'uniform')}
    draws = {'normal': torch.randn(counts['normal'], generator=generator,
                                   device=device),
             'uniform': torch.rand(counts['uniform'], generator=generator,
                                   device=device)}
    offsets = dict.fromkeys(draws, 0)
    state = {}
    for name, shape, law in entries:
        if law[0] in draws:
            size = math.prod(shape)
            values = draws[law[0]][offsets[law[0]]:offsets[law[0]] + size]
            offsets[law[0]] += size
            values = law[1] * values if law[0] == 'normal' else \
                law[1] * (2 * values - 1)
            state[name] = values.reshape(shape)
        elif law[0] == 'constant':
            state[name] = torch.full(shape, law[1], device=device)
    for name, shape, law in entries:
        if law[0] == 'norm':
            v = state[name[:-1] + 'v']
            state[name] = torch.linalg.vector_norm(
                v, dim=(0, 1), keepdim=True)
    return state


def _law(module, full, name):
    """('normal', std), ('uniform', bound), ('constant', value) or
    ('norm',) of one parameter"""
    if name == 'layer_weights':
        return ('constant', 1. / module.layer_weights.numel())
    if name == 'gru_rel_pos_const':
        return ('constant', 1.)
    if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
        return ('constant', 1. if name == 'weight' else 0.)
    if isinstance(module, torch.nn.Embedding):
        return ('normal', 1.)
    if name == 'weight_g':
        return ('norm',)
    if name == 'weight_v':
        return ('normal', 2. / math.sqrt(
            module.kernel * module.weight_v.shape[0]))
    if name == 'bias' and hasattr(module, 'weight_v'):
        return ('constant', 0.)
    if full.startswith('wavlm.feature_projection.projection'):
        return ('uniform', 1. / math.sqrt(module.in_features))
    if isinstance(module, torch.nn.Conv1d):
        return ('normal', math.sqrt(2. / module.fan_in))
    if isinstance(module, torch.nn.Linear):
        return ('normal', .02) if name == 'weight' else ('constant', 0.)
    raise ValueError(f'no initialisation law for {full}')


class Keep:
    """Keeps the 16 kHz audio a WavLMXVector's `features` reads and the
    x-vector its `xvector` returns, wrapping the two methods of the one
    object"""

    def __init__(self, encoder):
        self.audio = self.raw = None
        features, xvector = encoder.features, encoder.xvector

        def keep_features(audio, *args, **kwargs):
            self.audio = audio[0]
            return features(audio, *args, **kwargs)

        def keep_xvector(*args, **kwargs):
            self.raw = xvector(*args, **kwargs)[0]
            return self.raw[None]

        encoder.features, encoder.xvector = keep_features, keep_xvector


class Program(edit.Program):
    """The port's zero-shot edit chain with the harness's weights"""

    def __init__(self, context, states):
        super().__init__(context, states)
        encoder = wavlm_model(
            self.port, context.cell.config_file['wavlm'],
            torch.bfloat16 if self.config.PRECISION == 'bfloat16'
            else torch.float32)
        self.encoder = weights.load(
            encoder.to(self.device), states['wavlm']).eval()
        self.kept = Keep(self.encoder)
        # Each request's 16 kHz audio as WavLM last read it, for the check
        self.resampled = {}

    def serve(self, request):
        port, config, tracer = self.port, self.config, self.tracer
        with tracer.range('speaker'):
            xvector = port.preprocess.speaker.from_audio(
                request.reference, encoder=self.encoder, config=config,
                device=self.device)
        raw = self.kept.raw
        self.resampled[id(request)] = self.kept.audio
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
                *edited, generator=self.models['generator'], speaker=xvector,
                device=self.device)
        return Served(features, path, edited, audio, xvector, raw,
                      self.kept.audio.shape[-1])

    def close(self):
        super().close()
        self.encoder = None


def reference_models(config, states, precision, device, sizes):
    """The reference's pitch CNN, PPG encoder, zero-shot generator and
    WavLM with `states`, in `precision`"""
    models = common.reference_model_set(
        config, {name: states[name] for name in ('pitch', 'ppg')},
        precision, device)
    generator = reference_wavlm.ZeroShotGenerator(config, precision)
    generator.load_state_dict(states['generator'])
    models['generator'] = generator.to(device).eval()
    encoder = reference_wavlm.WavLMXVector(precision, **sizes)
    encoder.load_state_dict(states['wavlm'])
    models['wavlm'] = encoder.to(device).eval()
    return models


def resample(audio, rate):
    """(S,) float32 16 kHz audio of (1, T) audio at `rate`: polyphase, as
    `scipy.signal.resample_poly` takes it"""
    gcd = math.gcd(int(rate), WAVLM_RATE)
    return scipy.signal.resample_poly(
        audio[0], WAVLM_RATE // gcd, int(rate) // gcd).astype(np.float32)


class Control(edit.Control):
    """The reference in the program's place, in scaled float8"""

    def __init__(self, context, states):
        self.config, self.device = context.config, context.device
        self.all = reference_models(
            self.config, states, FLOAT8, self.device,
            context.cell.config_file['wavlm'])
        self.resampled = {}

    def serve(self, request):
        resampled = torch.from_numpy(resample(
            request.reference, self.config.SAMPLE_RATE)).to(self.device)
        self.resampled[id(request)] = resampled
        with exact():
            raw = self.all['wavlm'](resampled)['xvector']
        xvector = raw / raw.norm()
        self.models = dict(self.all, generator=reference_wavlm.Bound(
            self.all['generator'], xvector))
        served = super().serve(request)
        return Served(served.features, served.path, served.edited,
                      served.audio, xvector, raw, resampled.shape[-1])

    def close(self):
        self.all = self.models = None


@dataclasses.dataclass
class State:
    requests: list
    states: dict
    system: object


def setup(context):
    import promonet_tpu_torch as port
    config, traffic = context.config, context.cell.traffic
    sizes = context.cell.config_file['wavlm']
    modules = {
        'pitch': port.preprocess.PitchCNN(),
        'ppg': port.preprocess.PPGEncoder(),
        'generator': port.models.Generator(config)}
    states = common.seeded_states(
        modules, context.seed, context.device, context.cell.config_file)
    states['wavlm'] = wavlm_state(
        wavlm_model(port, sizes), generate.subseeds(context.seed, 5)[4],
        context.device)
    system = (Program if context.system == 'program' else Control)(
        context, states)
    started = time.perf_counter()
    served = requests(traffic, context.seed, config)
    made = time.perf_counter()
    for request in served:
        system.serve(request)
    harness.log(f'requests made in {made - started:.3f} s, warm-up '
                f'{time.perf_counter() - made:.3f} s')
    return State(served, states, system)


def run(context, state, seconds):
    rate = context.config.SAMPLE_RATE
    window = common.closed_loop(
        context.tracer, state.requests, state.system.serve, seconds,
        lambda request, served: served.audio.shape[-1] / rate)
    window.work.update(
        preprocess_frames=[request.frames for request, _ in window.records],
        generator_calls=[[request.out_frames()]
                         for request, _ in window.records],
        speaker_samples=[served.samples for _, served in window.records])
    return window


def check(context, state, window):
    """The numbers compared, each the largest over the sampled requests"""
    config, traffic = context.config, context.cell.traffic
    checked = common.sample(
        window.records, traffic['checked'], context.seed,
        lambda record: record[1].samples)
    resampled = state.system.resampled
    state.system.close()
    state.system = None
    if context.device.type == 'cuda':
        torch.cuda.empty_cache()
    models = reference_models(config, state.states, EXACT, context.device,
                              context.cell.config_file['wavlm'])
    numbers = {}
    for request, served in checked:
        with exact():
            reference = models['wavlm'](resampled[id(request)])
        found = {'speaker': common.relative(served.raw, reference['xvector'])}
        bound = dict(models, generator=reference_wavlm.Bound(
            models['generator'], served.xvector))
        found.update(edit.judge(request, served, None, bound, config,
                                context.device))
        for name, value in found.items():
            numbers[name] = max(numbers.get(name, 0.), value)
    return numbers
