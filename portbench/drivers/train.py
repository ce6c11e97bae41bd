"""The GAN training step, one step a call, on batches resident on the
device

Batches are `batch` rows of `chunk` samples made by the harness from the
seed on the device: harmonic audio along a random pitch contour with
noise where periodicity is low, its magnitude spectrogram and
full-band A-weighted loudness, a PPG, a speaker and augmentation ratios
per row. The set-up builds the port's training state
(`train.core.State`) with the harness's weights, drives it through its
first steps with `train.core.train_step` on batches whose rows all
differ, and hands that same state to the window, which calls the same
step on the following batches until the time is up.

End-to-end: `train_step_ms`, the window (ending in a synchronize) over
the steps completed in it.

The comparison holds the program to the reference twice, each time over
`checked_steps` steps: each step's generator and discriminator losses,
the first step's generated audio, the first step's gradient of every
leaf (worked out from Adam's first moment before and after it) and every
leaf's change over the steps. The start: the reference trains from the
same weights on the same first batches as the set-up did. The timed
path: once the window has closed, the same object takes the next steps
through the window's own call and feed, from a copy of its state (the
weights and AdamW's moments and step counts) that the reference starts
from (numbers `<name>.window`). The reference cannot follow the steps in
between: a GAN's run from two precisions drifts apart.
"""
import dataclasses
import math
import statistics
import sys
import time

import torch

from .. import generate, harness, weights
from ..harness import Window
from ..reference import dsp, train as reference_train
from ..reference import models as reference_models
from ..reference.precision import EXACT, FLOAT8, exact
from . import common


def make_batches(traffic, seed, config, device):
    """`batches` dicts of `batch` rows of `chunk` samples, on the device"""
    generator = torch.Generator(device=device).manual_seed(
        generate.subseeds(seed, 4)[3])
    rows, samples = traffic['batch'], traffic['chunk']
    frames = samples // config.HOPSIZE
    knots = max(2, frames // 8)

    def contour(count):
        values = torch.randn((rows, count, knots), generator=generator,
                             device=device)
        return torch.nn.functional.interpolate(
            values, size=frames, mode='linear', align_corners=True)

    out = []
    speakers = generate.draw(
        {'speaker': traffic['laws']['speaker']},
        rows * traffic['batches'], seed, config)['speaker']
    for index in range(traffic['batches']):
        base = 90. + 160. * torch.rand((rows, 1), generator=generator,
                                       device=device)
        pitch = base * 2 ** (0.25 * torch.tanh(contour(1)[:, 0]))
        periodicity = torch.sigmoid(2 * contour(1)[:, 0])
        # Harmonic audio along the pitch, noise where aperiodic
        hz = torch.nn.functional.interpolate(
            pitch[:, None], size=samples, mode='linear',
            align_corners=True)[:, 0]
        phase = 2 * math.pi * torch.cumsum(hz, -1) / config.SAMPLE_RATE
        voiced = sum(torch.sin(k * phase) / k for k in range(1, 9))
        aperiodic = torch.nn.functional.interpolate(
            (1 - periodicity)[:, None], size=samples, mode='linear',
            align_corners=True)[:, 0]
        noise = torch.randn((rows, samples), generator=generator,
                            device=device)
        gain = 0.05 + 0.25 * torch.rand((rows, 1), generator=generator,
                                        device=device)
        audio = gain * (voiced / 2 + aperiodic * noise) / 2
        padded = dsp.reflect_pad(audio, (config.NUM_FFT - config.HOPSIZE) // 2)
        spectrograms = dsp.stft_magnitude(
            padded, config.NUM_FFT, config.HOPSIZE, 1e-6)
        loudness = torch.stack([
            dsp.loudness(row[None], config) for row in audio])
        ratios = config.AUGMENTATION_RATIO_MIN + (
            config.AUGMENTATION_RATIO_MAX - config.AUGMENTATION_RATIO_MIN) * \
            torch.rand((2, rows), generator=generator, device=device)
        out.append({
            'audio': audio[:, None],
            'spectrograms': spectrograms,
            'loudness': loudness,
            'pitch': pitch,
            'periodicity': periodicity,
            'ppg': torch.softmax(3. * contour(config.PPG_CHANNELS), dim=1),
            'speakers': torch.as_tensor(
                speakers[index * rows:(index + 1) * rows], device=device),
            'spectral_balance_ratios': ratios[0],
            'loudness_ratios': ratios[1]})
    return out


class Program:
    """The port's training state and step with the harness's weights"""

    def __init__(self, context, states):
        import promonet_tpu_torch as port
        from promonet_tpu_torch.train import core
        self.core, config = core, context.config
        generator = weights_loaded(
            port.models.Generator(config), states['generator'],
            context.device)
        discriminator = weights_loaded(
            port.models.Discriminator(config), states['discriminator'],
            context.device)
        self.trainer = core.State(generator, discriminator, config)
        self.output, self.watching = None, False
        generator.register_forward_hook(self._keep_output)

    def _keep_output(self, module, inputs, output):
        if self.watching:
            self.output, self.watching = output.detach().clone(), False

    def watch(self):
        """Keep the generator's next output"""
        self.watching = True

    def step(self, batch):
        metrics = self.core.train_step(self.trainer, batch)
        return (metrics['loss/generator/total'],
                metrics['loss/discriminator/total'])


class Reference:
    """The reference's trainer, as a system: the control in the program's
    place (`Float8`), and the yardstick (`Exact`)"""

    def __init__(self, context, states, precision):
        config = context.config
        generator = reference_models.Generator(config, precision).to(
            context.device)
        generator.load_state_dict(states['generator'])
        discriminator = reference_train.Discriminator(config, precision).to(
            context.device)
        discriminator.load_state_dict(states['discriminator'])
        self.trainer = reference_train.Trainer(
            generator, discriminator, config)
        self.output, self.watching = None, False

    def watch(self):
        self.watching = True

    def step(self, batch):
        with exact(), torch.enable_grad():
            generated, total, discriminator_total = self.trainer.step(batch)
        if self.watching:
            self.output, self.watching = generated, False
        return total, discriminator_total


def weights_loaded(model, state, device):
    return weights.load(model.to(device), state)


def leaves(trainer):
    """{'generator.<name>' or 'discriminator.<name>': leaf} of the
    program's `train.core.State` or the reference's `Trainer`"""
    out = {f'generator.{name}': trainer.trainable[name]
           for name in trainer.names}
    out.update({f'discriminator.{name}': value for name, value in
                trainer.discriminator.named_parameters()})
    return out


def optimized_leaves(trainer):
    """{leaf name: (its optimizer, the leaf)}"""
    return {name: (trainer.generator_optimizer
                   if name.startswith('generator.')
                   else trainer.discriminator_optimizer, value)
            for name, value in leaves(trainer).items()}


def snapshot(trainer):
    """A copy of the trainer's state: each leaf and its AdamW state"""
    return {name: (value.detach().clone(), {
        key: item.clone() if torch.is_tensor(item) else item
        for key, item in optimizer.state[value].items()})
        for name, (optimizer, value) in optimized_leaves(trainer).items()}


def restore(trainer, saved):
    """Put a `snapshot` into another trainer, leaf by leaf name"""
    targets = optimized_leaves(trainer)
    if set(targets) != set(saved):
        raise ValueError('the two trainers have different leaves')
    with torch.no_grad():
        for name, (value, moments) in saved.items():
            optimizer, leaf = targets[name]
            leaf.copy_(value)
            optimizer.state[leaf] = {
                key: torch.tensor(float(item), dtype=torch.float32)
                if key == 'step' else item.to(leaf.device).clone()
                for key, item in moments.items()}


@dataclasses.dataclass
class Readings:
    """What the first steps did: each step's (generator, discriminator)
    losses, the first step's output, per-leaf first-gradient norms and
    per-leaf change norms"""
    losses: list
    output: torch.Tensor
    gradients: dict
    changes: dict


def drive(system, batches, beta1):
    """Step through `batches` and read the steps; the first step's
    gradient is (m1 - beta1 m0) / (1 - beta1) from AdamW's first moment
    before (m0, zero before any step) and after it (m1)"""
    initial = {name: value.detach().clone()
               for name, value in leaves(system.trainer).items()}
    before = {name: optimizer.state[value]['exp_avg'].clone()
              for name, (optimizer, value) in
              optimized_leaves(system.trainer).items()
              if 'exp_avg' in optimizer.state[value]}
    losses, gradients = [], None
    system.watch()
    for index, batch in enumerate(batches):
        losses.append(tuple(float(value) for value in system.step(batch)))
        if index == 0:
            gradients = {}
            for name, (optimizer, value) in optimized_leaves(
                    system.trainer).items():
                moment = optimizer.state[value]['exp_avg']
                if name in before:
                    moment = moment - beta1 * before[name]
                gradients[name] = float(moment.norm()) / (1 - beta1)
    changes = {name: float((value.detach() - initial[name]).norm())
               for name, value in leaves(system.trainer).items()}
    return Readings(losses, system.output, gradients, changes)


@dataclasses.dataclass
class State:
    batches: list
    states: dict
    system: object
    readings: Readings
    next: int = 0            # the index of the batch the window would take next


def setup(context):
    import promonet_tpu_torch as port
    config, traffic = context.config, context.cell.traffic
    states = common.seeded_states(
        {'generator': port.models.Generator(config),
         'discriminator': port.models.Discriminator(config)},
        context.seed, context.device, context.cell.config_file)
    batches = make_batches(traffic, context.seed, config, context.device)
    system = Program(context, states) if context.system == 'program' \
        else Reference(context, states, FLOAT8)
    readings = drive(system, batches[:traffic['checked_steps']],
                     config.OPTIMIZER.get('b1', .8))
    for index in range(traffic['warmup_steps']):
        system.step(batches[(traffic['checked_steps'] + index) %
                            len(batches)])
    return State(batches, states, system, readings)


def run(context, state, seconds):
    """Steps until `seconds` have passed; the window ends in a
    synchronize after the last step"""
    traffic, tracer = context.cell.traffic, context.tracer
    first = traffic['checked_steps'] + traffic['warmup_steps']
    steps, failed = 0, 0
    with tracer.window():
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            batch = state.batches[(first + steps) % len(state.batches)]
            try:
                with tracer.range('step'):
                    state.system.step(batch)
            except Exception as error:  # a failed step is counted
                failed += 1
                print(f'portbench: step failed: {error!r}', flush=True,
                      file=sys.stderr)
            steps += 1
        if context.device.type == 'cuda':
            torch.cuda.synchronize()
        end = time.perf_counter()
    state.next = first + steps
    elapsed = end - start
    work = {'steps': steps, 'rows': traffic['batch'],
            'samples': traffic['chunk']}
    return Window(steps, failed, elapsed,
                  {'train_step_ms': 1e3 * elapsed / max(steps, 1)}, work)


def check(context, state, window):
    """The program's first steps, and its steps after the window from
    its own state, against the reference's"""
    traffic = context.cell.traffic
    beta1 = context.config.OPTIMIZER.get('b1', .8)
    count = traffic['checked_steps']
    after = [state.batches[(state.next + index) % len(state.batches)]
             for index in range(count)]
    saved = snapshot(state.system.trainer)
    timed = drive(state.system, after, beta1)
    state.system = None
    if context.device.type == 'cuda':
        torch.cuda.empty_cache()
    started = time.perf_counter()
    start = drive(Reference(context, state.states, EXACT),
                  state.batches[:count], beta1)
    reference = Reference(context, state.states, EXACT)
    restore(reference.trainer, saved)
    saved = None
    window_reference = drive(reference, after, beta1)
    if context.device.type == 'cuda':
        harness.log(
            f'reference: {time.perf_counter() - started:.1f} s, peak '
            f'{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB')
    numbers = {}
    for suffix, ours, theirs in (('', state.readings, start),
                                 ('.window', timed, window_reference)):
        log_gaps(suffix, ours, theirs)
        numbers.update({name + suffix: value
                        for name, value in compare(ours, theirs).items()})
    return numbers


def log_gaps(suffix, program, reference):
    for reading in ('gradients', 'changes'):
        ours, theirs = getattr(program, reading), getattr(reference, reading)
        worst = sorted(theirs, key=lambda name: -abs(
            ours.get(name, math.inf) - theirs[name]) / max(theirs[name], 1e-30))
        harness.log(f'{reading}{suffix}, largest relative gaps: ' + ', '.join(
            f'{name} {ours.get(name)!r} against {theirs[name]!r}'
            for name in worst[:3]))


def compare(program, reference):
    """loss: the largest relative gap of a step's loss; output: the first
    step's audio, relative; gradient and change: the worst leaf's gap of
    norms over the larger of its reference norm and the median leaf's;
    gradient.median: the median leaf's such gap of the first gradient.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of `change` and
    `gradient.median`."""
    def gaps(ours, theirs, names):
        median = sorted(theirs[name] for name in theirs)[len(theirs) // 2]
        if set(ours) != set(theirs):
            return [math.inf]
        return [abs(ours[name] - theirs[name]) / max(theirs[name], median,
                                                     1e-30)
                for name in names]

    def worst(ours, theirs, names):
        return max(gaps(ours, theirs, names))

    losses = max(
        abs(ours - theirs) / max(abs(theirs), 1e-30)
        for step_ours, step_theirs in zip(program.losses, reference.losses)
        for ours, theirs in zip(step_ours, step_theirs))
    if len(program.losses) != len(reference.losses):
        losses = math.inf
    gradients = reference.gradients
    median = sorted(gradients.values())[len(gradients) // 2]
    moving = [name for name, value in gradients.items()
              if value >= 1e-3 * median]
    return {
        'loss': losses,
        'output': common.relative(program.output, reference.output),
        'gradient': worst(program.gradients, gradients, gradients),
        'gradient.median': statistics.median(
            gaps(program.gradients, gradients, moving)),
        'change': worst(program.changes, reference.changes, moving)}
