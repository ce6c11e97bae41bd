"""GAN training (counterpart of `promonet_tpu/train/core.py`)

One step, in the JAX package's order: the generator's forward pass runs
once; the discriminators are updated against its detached output; the
generator's losses (mel ×MEL_LOSS_WEIGHT, then feature matching and the
adversarial terms) run through the *updated* discriminators; then the
generator's gradient max and min, the optional inf-norm clip
(GRADIENT_CLIP_GENERATOR) and the optimizer step. The discriminators
start at DISCRIMINATOR_START_STEP, the adversarial terms at
ADVERSARIAL_LOSS_START_STEP. Models compute in PRECISION (bf16 by
default) with float32 parameters, gradients and losses; bf16 needs no
loss scaling.

The generator is trained through its weight norm, as the JAX package
trains it: the trainer holds the generator's trainable set (each
weight-normed weight as (v, g), `models.modules.split`), materialises the
effective weights each step and calls the generator functionally
(`torch.func.functional_call`) on its training route (`train=True`: no
residual-block kernel, each Block recomputed in the backward pass under
REMAT). Validation loads the effective weights into the generator, whose
inference route serves them with the kernels (K1 on the card), and
preprocesses its audio again (K2). The discriminators hold their (v, g)
as parameters.

A run directory holds `generator-<step:08d>.pt` (the effective weights
as 'params', which `load.generator` and every synthesis path read, beside
'trainable', 'optimizer', 'step' and 'epoch') and
`discriminator-<step:08d>.pt` ('params', 'optimizer'), the newest three
of each and every multiple of 20000 kept, and `metrics.jsonl`. A run
resumes from its newest readable generator checkpoint; a checkpoint with
'params' alone (a converted release, or one written before training was
ported) warm-starts the generator with v = weight and g = its norm,
keeps its step, and starts the discriminators and both optimizers anew,
as the JAX package does with a release checkpoint.

FARGAN trains on its own training route: a frame loop that autograd runs
back through, with the JAX package's additive noise drawn from a noise
source. By default that is a `torch.Generator` on the training device
seeded with RANDOM_SEED + 1 when the `State` is made, one stream over the
run's steps, which starts anew when a run resumes, as the JAX package's
key chain does. The first HOPSIZE * FARGAN_PREVIOUS_FRAMES samples of
each item's audio start FARGAN's history (`previous_samples_of`), and
they replace that many generated samples before any loss or
discriminator sees the output; validation passes them too.

The HiFi-GAN, FARGAN and Vocos generators train, over interpretable
features or (SPECTROGRAM_ONLY, the `MelGenerator`) over spectrograms.

Training data comes from the host loader (`data.loader`), or, where
RESIDENT_DATA resolves on (by default on a CUDA device, unless
SPECTROGRAM_ONLY or ZERO_SHOT), from the whole training partition copied
to the card once (`data.resident`): each step's crops are drawn and
gathered on the card, and the mel loss's target spectrogram is computed
from the audio crop there. The resident path runs `steps_per_dispatch`
steps back to back with no host read between them; the metrics passed to
`callback` and logged are the last step's, and evaluation, checkpoints,
the progress line and the pause check come at dispatch boundaries, as in
the JAX package. The host loader takes one step per dispatch.

Data parallelism (`parallel`, one process per card under `torchrun`):
the global batch of BATCH_SIZE is split over the mesh's 'data' axis (the
host batch by `parallel.shard_batch`, the resident corpus by its stems
and `data.resident.sample_sharded`); each model's gradients are averaged
over the world as one flat all-reduce before the generator's gradient
max, min and clip, and before each optimizer step, so every rank takes
the same step; the metrics of each dispatch are averaged over the ranks.
Rank 0 alone validates and writes checkpoints, metrics, notifications and
the pause protocol's files; the other ranks wait for it at a barrier.

A run is wrapped in `utils.notify.notify('train')`, registers with
`utils.pause` and, once per dispatch, touches the heartbeat and honours a
pause request: it synchronizes the card, writes a checkpoint, and idles
until released.
"""
import math
import sys
import time
import traceback
import types
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from .. import config as config_module
from .. import data
from .. import device as device_module
from .. import load
from .. import parallel
from .. import plot
from .. import preprocess
from ..data import resident as resident_module
from ..evaluate.metrics import Metrics
from ..models import (
    Discriminator, Generator, MelGenerator, bridge, fargan, init)
from ..models.modules import materialize, normed, split
from ..utils import checkpoint as checkpoint_module
from ..utils import cli
from ..utils import log
from ..utils import pause
from ..utils import timer
from ..utils.notify import notify
from . import graphs as graphs_module
from . import loss as loss_module


###############################################################################
# Entry point
###############################################################################


@notify('train')
def train(
    directory,
    dataset=None,
    train_partition='train',
    valid_partition='valid',
    adapt_from=None,
    gpu=None,
    steps=None,
    config=None,
    device='cuda',
    callback=None
):
    """Train a generator and its discriminators; returns the `State`

    Arguments
        directory: the run directory, for checkpoints and metrics.jsonl
        dataset: the dataset's name under config.CACHE_DIR (None:
            config.TRAINING_DATASET)
        train_partition, valid_partition: partition names
        adapt_from: a generator checkpoint to start from when the run has
            none (then ADAPTATION_STEPS more steps are taken)
        gpu: a GPU index as the command line takes it, overriding
            `device`; -1 is the CPU
        steps: the step to stop at (None: STEPS, plus ADAPTATION_STEPS
            when adapting)
        config: a `config.Config`; None reads the environment's
        device: where to train; 'cuda' raises on a host without a card
        callback: called as callback(step, metrics) after each dispatch,
            with the dispatch's last step and its metrics, tensors on the
            device

    In an initialised `torch.distributed` process group the run is one
    rank of a data-parallel run (`parallel.create_mesh`).
    """
    config = config_module.default() if config is None else config
    _check_trainable(config)
    if gpu is not None:
        device = cli.device(gpu)
    device = device_module.resolve(device)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if dataset is None:
        dataset = config.TRAINING_DATASET
    if steps is None:
        steps = config.STEPS
        if adapt_from:
            steps += config.ADAPTATION_STEPS

    mesh = parallel.create_mesh(config=config, device=device)
    lead = mesh.rank == 0
    shards, shard = mesh.size('data'), mesh.coordinate('data')
    if config.BATCH_SIZE % shards:
        raise ValueError(
            f'BATCH_SIZE = {config.BATCH_SIZE} does not divide over the '
            f'{shards} ranks of the data axis')

    resident = resident_data(config, device)
    if resident:
        train_data = resident_module.to_device(
            resident_module.pack(dataset, train_partition, config), device,
            shard, shards)
        sampler = torch.Generator(device=device).manual_seed(
            config.RANDOM_SEED + 2 + shard)
        train_loader = None
    else:
        train_loader = data.loader(
            dataset, train_partition, config, native=device.type == 'cuda')
        if len(train_loader) == 0:
            # The JAX trainer waits forever for a batch here
            raise ValueError(
                f'Partition {train_partition!r} of {dataset!r} has '
                f'{len(train_loader.dataset)} items, fewer than one batch '
                f'of BATCH_SIZE = {config.BATCH_SIZE}')
    valid_loader = (
        data.loader(dataset, valid_partition, config) if lead else None)

    state = create_state(config, device)
    latest = checkpoint_module.latest_path(directory)
    source = latest if latest is not None else adapt_from
    if source is not None:
        step, epoch = load_checkpoint(state, source)
    else:
        step, epoch = 0, 0
    state.mesh = mesh
    parallel.shard_pytree(
        [state.trainable, dict(state.discriminator.named_parameters())],
        mesh)

    # Validation's feature extractors (K2 decodes the pitch on the card)
    extractors = (
        load.pitch_model(config=config, device=device)
        if config.PITCH_ESTIMATOR == 'cnn' else None,
        load.ppg_model(config=config, device=device)) if lead else None

    def batches():
        """This rank's host batches, on the device"""
        nonlocal epoch
        while True:
            train_loader.sampler.set_epoch(epoch)
            for batch in train_loader:
                # Skip examples that are too short
                if batch['audio'].shape[-1] < config.CHUNK_SIZE:
                    continue
                yield to_device(parallel.shard_batch(batch, mesh), device)
            epoch += 1

    def resident_batch():
        """This rank's crops of the resident corpus, drawn on the card"""
        batch = resident_module.sample_sharded(
            train_data, sampler, shard, shards, config.BATCH_SIZE, config)
        batch['spectrograms'] = preprocess.spectrogram.from_audio(
            batch['audio'], config)
        return batch

    host_batches = None if resident else batches()
    advance = steps_per_dispatch(steps, config) if resident else 1
    drain = pause.synchronize(device)

    def on_pause():
        save_checkpoint(directory, state, step, epoch)

    progress_interval = 2000
    progress_clock, progress_step = time.time(), step
    if lead:
        pause.register_trainer(config)
    try:
        while True:
            if lead:
                pause.heartbeat(config)
            _maybe_pause(mesh, drain, on_pause, config)

            for _ in range(advance):
                batch = resident_batch() if resident else next(host_batches)
                metrics = train_step(
                    state, batch,
                    discriminate=step >= config.DISCRIMINATOR_START_STEP,
                    adversarial=step >= config.ADVERSARIAL_LOSS_START_STEP)
            metrics = average_metrics(metrics, mesh)
            if callback is not None:
                callback(step + advance - 1, metrics)

            if lead and step and step % progress_interval < advance:
                now = time.time()
                rate = (step - progress_step) / max(now - progress_clock, 1e-9)
                print(
                    f'[{time.strftime("%H:%M:%S")}] step {step}/{steps} · '
                    f'{rate:.1f} steps/s · '
                    f'eta {(steps - step) / max(rate, 1e-9) / 3600:.2f} h',
                    flush=True)
                progress_clock, progress_step = now, step

            if step % config.EVALUATION_INTERVAL == 0:
                if lead:
                    log.update(directory, step, scalars={
                        name: float(value) for name, value in metrics.items()})
                    evaluate(directory, step, state, valid_loader, extractors)
                _barrier(mesh)

            if step and step % config.CHECKPOINT_INTERVAL == 0:
                if lead:
                    save_checkpoint(directory, state, step, epoch)
                _barrier(mesh)

            step += advance
            if step >= steps:
                break

        drain()
    finally:
        if lead:
            pause.unregister_trainer(config)
    if lead:
        save_checkpoint(directory, state, step, epoch)
    _barrier(mesh)
    return state


def resident_data(config, device):
    """Whether a run trains from the device-resident corpus: RESIDENT_DATA,
    or where that is None, on a CUDA device unless SPECTROGRAM_ONLY (as
    the JAX package on its accelerator) or ZERO_SHOT (whose x-vectors the
    resident corpus does not carry)"""
    if config.RESIDENT_DATA is not None:
        return bool(config.RESIDENT_DATA)
    return (torch.device(device).type == 'cuda' and
            not config.SPECTROGRAM_ONLY and not config.ZERO_SHOT)


def steps_per_dispatch(total_steps=None, config=None):
    """Training steps run back to back in one dispatch (resident data)

    STEPS_PER_DISPATCH where it is set; auto (None): the largest K <= 32
    that divides every step cadence (the evaluation and checkpoint
    intervals, the loss-warmup boundaries and the total budget), so that
    every interval event lands exactly on a dispatch boundary.
    """
    config = config_module.default() if config is None else config
    if config.STEPS_PER_DISPATCH is not None:
        return max(1, int(config.STEPS_PER_DISPATCH))
    cadence = math.gcd(config.EVALUATION_INTERVAL, config.CHECKPOINT_INTERVAL)
    for boundary in (
        config.DISCRIMINATOR_START_STEP,
        config.ADVERSARIAL_LOSS_START_STEP,
        total_steps or 0,
    ):
        if boundary:
            cadence = math.gcd(cadence, boundary)
    for k in range(min(32, cadence), 0, -1):
        if cadence % k == 0:
            return k
    return 1


def average_metrics(metrics, mesh):
    """A step's metrics averaged over the ranks of a process group (one
    flat all-reduce); the metrics as they are without one"""
    if mesh is None or not mesh.group:
        return metrics
    names = sorted(metrics)
    values = parallel.all_reduce_mean(
        [metrics[name].float().reshape(1) for name in names], mesh)
    return {name: value[0] for name, value in zip(names, values)}


def _barrier(mesh):
    if mesh.group and mesh.world > 1:
        torch.distributed.barrier()


def _maybe_pause(mesh, drain, on_pause, config):
    """The pause check of a dispatch: rank 0 honours a request
    (`utils.pause.maybe_pause`); in a world of several ranks it tells the
    others, which drain and wait for it at a barrier"""
    if not (mesh.group and mesh.world > 1):
        return pause.maybe_pause(drain, on_pause=on_pause, config=config)
    lead = mesh.rank == 0
    flag = torch.tensor(
        [float(lead and pause.pause_file(config).exists())],
        device=mesh.device)
    torch.distributed.broadcast(flag, src=0)
    if not flag.item():
        return False
    if lead:
        paused = pause.maybe_pause(drain, on_pause=on_pause, config=config)
    else:
        drain()
        paused = True
    torch.distributed.barrier()
    return paused


def _check_trainable(config):
    if config.MODEL not in ('hifigan', 'fargan', 'vocos'):
        raise ValueError(
            f'Generator model {config.MODEL} is not defined: the HiFi-GAN, '
            'FARGAN and Vocos generators train')


###############################################################################
# State
###############################################################################


class State:
    """What a step changes: the generator's trainable set and optimizer,
    the discriminators and theirs

    generator: the `models.Generator`, called functionally in training
        and holding the effective weights for validation
    normed: {effective weight name: norm axes} of the generator
    names: the trainable set's names, in the optimizer's order
    trainable: {name: float32 leaf tensor}, (v, g) for each weight-normed
        weight (`models.modules.split`)
    discriminator: the `models.Discriminator`
    rng: the `torch.Generator` of FARGAN's training noise, on the
        generator's device, seeded with RANDOM_SEED + 1
    mesh: the `parallel.Mesh` whose ranks the gradients are averaged
        over (set by `train`; None trains alone)
    graphs: the `train.graphs.Graphs` of the last step's key, or None
        (`train_step`)
    notes: what the run has reported once (`evaluate`)
    """

    def __init__(self, generator, discriminator, config):
        self.config = config
        self.generator = generator.eval()
        self.normed = normed(generator)
        self.trainable = {
            name: value.detach().clone().requires_grad_()
            for name, value in split(
                dict(generator.named_parameters()), self.normed).items()}
        self.names = sorted(self.trainable)
        self.discriminator = discriminator
        self.generator_optimizer = build_optimizer(
            [self.trainable[name] for name in self.names], config)
        self.discriminator_optimizer = build_optimizer(
            list(discriminator.parameters()), config)
        self.rng = torch.Generator(
            device=self.trainable[self.names[0]].device).manual_seed(
                config.RANDOM_SEED + 1)
        self.mesh = None
        self.graphs = None
        self.notes = set()

    @property
    def device(self):
        """The device the state trains on"""
        return self.trainable[self.names[0]].device

    def effective(self):
        """The generator's effective weights, as a state dict"""
        return materialize(self.trainable, self.normed)


def build_optimizer(parameters, config):
    """The optimizer of config.OPTIMIZER over `parameters`

    'adamw' is `torch.optim.AdamW` with the JAX package's optax settings
    (decoupled weight decay scaled by the learning rate); 'adam' and
    'sgd' as there too. `train_step` makes Adam and AdamW capturable
    while its steps may be graphed (`train.graphs.capturable`).
    """
    spec = dict(config.OPTIMIZER)
    name = spec.pop('name', 'adamw')
    if name == 'adamw':
        return torch.optim.AdamW(
            parameters, lr=spec.get('lr', 2e-4),
            betas=(spec.get('b1', .8), spec.get('b2', .99)),
            eps=spec.get('eps', 1e-9),
            weight_decay=spec.get('weight_decay', 1e-2))
    if name == 'adam':
        return torch.optim.Adam(
            parameters, lr=spec.get('lr', 2e-4),
            betas=(spec.get('b1', .9), spec.get('b2', .999)),
            eps=spec.get('eps', 1e-8))
    if name == 'sgd':
        return torch.optim.SGD(
            parameters, lr=spec.get('lr', 1e-3),
            momentum=spec.get('momentum', 0.))
    raise ValueError(f'Optimizer {name} is not defined')


def create_state(config, device, seed=None):
    """A fresh `State` on `device`: the generator seeded from `seed` (None:
    RANDOM_SEED) and the discriminators from `seed` + 1 (`models.init`)"""
    seed = config.RANDOM_SEED if seed is None else seed
    generator = (MelGenerator if config.SPECTROGRAM_ONLY else Generator)(
        config)
    generator = init.seeded(generator, seed).to(device)
    discriminator = init.seeded(Discriminator(config), seed + 1).to(device)
    return State(generator, discriminator, config)


def example_batch(config, batch_size=1, frames=None):
    """A zero batch of the training shapes, as numpy"""
    if frames is None:
        frames = config.CHUNK_SIZE // config.HOPSIZE
    num_freqs = config.WINDOW_SIZE // 2 + 1
    return {
        'loudness': np.full((batch_size, num_freqs, frames), -60., np.float32),
        'pitch': np.full((batch_size, frames), 150., np.float32),
        'periodicity': np.full((batch_size, frames), .5, np.float32),
        'ppg': np.full(
            (batch_size, config.PPG_CHANNELS, frames),
            1. / config.PPG_CHANNELS, np.float32),
        'speakers': np.zeros((batch_size,), np.int32),
        'spectral_balance_ratios': np.ones((batch_size,), np.float32),
        'loudness_ratios': np.ones((batch_size,), np.float32),
        'spectrograms': np.full(
            (batch_size, num_freqs, frames), 1e-3, np.float32),
        'audio': np.zeros(
            (batch_size, 1, frames * config.HOPSIZE), np.float32)}


def to_device(batch, device):
    """A batch's arrays as tensors on `device` (pinned copies to a card);
    speaker ids as int64"""
    device = torch.device(device)
    out = {}
    for name, value in batch.items():
        if not isinstance(value, np.ndarray):
            out[name] = value
            continue
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if name == 'speakers' and not tensor.is_floating_point():
            tensor = tensor.long()
        if device.type == 'cuda':
            tensor = tensor.pin_memory()
        out[name] = tensor.to(device, non_blocking=True)
    return out


def previous_samples_of(batch, config):
    """FARGAN's starting history from a batch: the first HOPSIZE *
    FARGAN_PREVIOUS_FRAMES samples of its audio; None for the other
    backbones"""
    if config.MODEL != 'fargan':
        return None
    return batch['audio'][..., :config.HOPSIZE * config.FARGAN_PREVIOUS_FRAMES]


def generator_args(batch, config):
    """The generator's inputs from a batch (on the device): the
    interpretable features, or under SPECTROGRAM_ONLY the spectrograms;
    then speakers and the augmentation ratios"""
    features = (
        (batch['spectrograms'],) if config.SPECTROGRAM_ONLY else (
            batch['loudness'], batch['pitch'], batch['periodicity'],
            batch['ppg']))
    return features + (
        batch['speakers'], batch['spectral_balance_ratios'],
        batch['loudness_ratios'])


###############################################################################
# Checkpoints
###############################################################################


def optimizer_state(optimizer, names, parameters):
    """{'step': int (where the optimizer counts), and each state tensor
    by kind and parameter name} of a torch optimizer"""
    saved = {}
    for name, parameter in zip(names, parameters):
        for kind, value in optimizer.state.get(parameter, {}).items():
            if kind == 'step':
                saved['step'] = int(value)
            else:
                saved.setdefault(kind, {})[name] = value
    return saved


def load_optimizer_state(optimizer, names, parameters, saved):
    """Put an `optimizer_state` back into a torch optimizer, the step
    count where the optimizer keeps it: on each parameter's device where
    it is capturable, else on the host"""
    capturable = any(
        group.get('capturable', False) for group in optimizer.param_groups)
    for name, parameter in zip(names, parameters):
        state = {
            kind: values[name].to(parameter) for kind, values in saved.items()
            if kind != 'step'}
        if not state:
            continue
        if 'step' in saved:
            state['step'] = torch.tensor(
                float(saved['step']),
                device=parameter.device if capturable else 'cpu')
        optimizer.state[parameter] = state


def _discriminator_parameters(state):
    names, parameters = zip(*state.discriminator.named_parameters())
    return list(names), list(parameters)


def save_checkpoint(directory, state, step, epoch):
    """Write both models' checkpoints for `step`, then prune the run

    The discriminators' file is written first: the generator's, which
    resuming looks for, lands last.
    """
    directory = Path(directory)
    names, parameters = _discriminator_parameters(state)
    checkpoint_module.save(
        directory / f'discriminator-{step:08d}.pt',
        state.discriminator.state_dict(), step=step, epoch=epoch,
        optimizer=optimizer_state(
            state.discriminator_optimizer, names, parameters))
    with torch.no_grad():
        params = dict(state.generator.state_dict(), **state.effective())
    checkpoint_module.save(
        directory / f'generator-{step:08d}.pt', params, step=step,
        epoch=epoch, trainable=state.trainable,
        optimizer=optimizer_state(
            state.generator_optimizer, state.names,
            [state.trainable[name] for name in state.names]))
    checkpoint_module.prune(directory)


def load_checkpoint(state, generator_path):
    """Restore a generator checkpoint (and the discriminators' beside it)
    into `state`; returns (step, epoch)

    A checkpoint without 'trainable' warm-starts the generator from its
    effective weights (`models.modules.split`) and leaves both optimizers
    and the discriminators as they are. A JAX checkpoint (an orbax
    directory, such as the release generator, and the JAX trainer's
    `discriminator-*` beside it) is carried over by `models.bridge`, its
    weight norm as (v, g) and its AdamW moments where it holds them, as
    the JAX trainer restores it. The CUDA graphs of `state`'s steps are
    dropped: the next step runs eagerly.
    """
    state.graphs = None
    generator_path = Path(generator_path)
    payload = _payload(generator_path, 'generator')
    trainable = payload.get('trainable')
    if trainable is None:
        trainable = split(payload['params'], state.normed)
    if set(trainable) != set(state.trainable):
        raise ValueError(
            f'{generator_path} does not fit the configured generator')
    with torch.no_grad():
        for name, value in trainable.items():
            state.trainable[name].copy_(value)
    if 'optimizer' in payload:
        load_optimizer_state(
            state.generator_optimizer, state.names,
            [state.trainable[name] for name in state.names],
            payload['optimizer'])

    discriminator_path = generator_path.parent / generator_path.name.replace(
        'generator', 'discriminator')
    if discriminator_path.exists():
        saved = _payload(discriminator_path, 'discriminator')
        state.discriminator.load_state_dict(saved['params'])
        names, parameters = _discriminator_parameters(state)
        load_optimizer_state(
            state.discriminator_optimizer, names, parameters,
            saved['optimizer'])
    return int(payload['step']), int(payload['epoch'])


def _payload(path, model):
    """A checkpoint's payload in the port's layout: a `.pt` file as saved,
    an orbax directory of `model` ('generator' or 'discriminator')
    through `models.bridge`"""
    if not checkpoint_module.is_orbax(path):
        return checkpoint_module.load(path, map_location='cpu')
    tree = checkpoint_module.load(path)
    if model == 'generator':
        def convert(params):
            return bridge.generator_state_dict(params, materialize=False)
        key = 'trainable'
    else:
        convert, key = bridge.discriminator_state_dict, 'params'
    payload = {key: convert(tree['params']), 'step': int(tree['step']),
               'epoch': int(tree['epoch'])}
    if tree.get('opt_state') is not None:
        payload['optimizer'] = bridge.optimizer_state(
            tree['opt_state'], convert)
    return payload


###############################################################################
# Train step
###############################################################################


def _gradients(total, parameters):
    """d total / d parameters, zeros where a parameter does not reach it"""
    gradients = torch.autograd.grad(total, parameters, allow_unused=True)
    return [
        torch.zeros_like(parameter) if gradient is None else gradient
        for parameter, gradient in zip(parameters, gradients)]


def _apply(optimizer, parameters, gradients):
    for parameter, gradient in zip(parameters, gradients):
        parameter.grad = gradient
    with warnings.catch_warnings():
        # A capturable optimizer stepped outside a graph: the eager
        # warm-up step of a graphed key
        warnings.filterwarnings(
            'ignore', message='This instance was constructed with capturable')
        optimizer.step()
    for parameter in parameters:
        parameter.grad = None


def train_step(state, batch, discriminate=True, adversarial=True,
               noise=None):
    """One GAN step on a batch of device tensors; returns the metrics,
    float32 scalar tensors on the device, by the JAX package's names

    noise: FARGAN's training noise source (`models.fargan.Uniform` or a
        callable like it); None draws from `state.rng`. Other backbones
        take none.

    The step is the span `train.step` (`utils.timer.span`; count
    `graphed`, 1 where CUDA graphs ran it) and its phases the spans
    `train.generator` (the generator's forward pass),
    `train.discriminator` (the discriminators' update), `train.losses`
    (the generator's losses through the updated discriminators),
    `train.backward` (the generator's gradients and their all-reduce) and
    `train.optimizer` (the gradients' extrema, the clip and the
    optimizer's step).

    On a CUDA device the steps of one key are replayed as CUDA graphs
    after an eager first step (`train.graphs`); `train.graphs.Graphs.
    replays` counts the steps the graphs ran.
    """
    with timer.span('train.step', graphed=0) as counts:
        graphable = graphs_module.graphable(state, batch, noise)
        graphs_module.capturable(state, graphable)
        if graphable and state.graphs is not None and state.graphs.key == \
                graphs_module.key(state, batch, discriminate, adversarial):
            if counts is not None:
                counts['graphed'] = 1
            return _replay(state, batch, discriminate, adversarial)
        # Before the eager step, so that the old graphs' memory is free
        state.graphs = None
        work, phases = _phases(state, batch, discriminate, adversarial, noise)
        for name, run in phases:
            with timer.span('train.' + name):
                run()
        if graphable:
            # The warm-up of the key: the next step of it is captured
            state.graphs = graphs_module.Graphs(graphs_module.key(
                state, batch, discriminate, adversarial))
        return work.metrics


def _replay(state, batch, discriminate, adversarial):
    """The step by `state.graphs`, captured first where they are not yet"""
    graphs = state.graphs
    if graphs.phases is None:
        # FARGAN draws its noise from `state.rng`
        draws = previous_samples_of(batch, state.config) is not None
        graphs.capture(state, batch, lambda static: _phases(
            state, static, discriminate, adversarial, None),
            state.rng if draws else None)
    return graphs.replay(
        state, batch, lambda batch: _generator_inputs(state, batch, None))


def _generator_inputs(state, batch, noise):
    """The generator's (args, kwargs) in a training step"""
    kwargs = {'train': True}
    previous_samples = previous_samples_of(batch, state.config)
    if previous_samples is not None:
        kwargs.update(
            previous_samples=previous_samples,
            noise=fargan.Uniform(state.rng) if noise is None else noise)
    return generator_args(batch, state.config), kwargs


def _phases(state, batch, discriminate, adversarial, noise):
    """The step's phases: (work, [(phase name, callable)]); run in order,
    the callables leave the generator's output as `work.raw` and the
    step's metrics as `work.metrics` on `work`"""
    config = state.config
    loss = loss_module
    discriminator = state.discriminator
    work = types.SimpleNamespace(metrics={})

    def generator():
        args, kwargs = _generator_inputs(state, batch, noise)
        work.raw = functional_call(
            state.generator, state.effective(), args, kwargs)
        work.generated = work.raw
        previous_samples = kwargs.get('previous_samples')
        if previous_samples is not None:
            # The history is given, not generated: the losses see it as
            # it is
            work.generated = torch.cat(
                (previous_samples,
                 work.raw[..., previous_samples.shape[-1]:]), -1)

    # Discriminators, against the detached output
    def update_discriminators():
        audio, metrics = batch['audio'], work.metrics
        real_logits, fake_logits, _, _ = discriminator(
            audio, work.generated.detach())
        total, real_losses, fake_losses = loss.discriminator(
            real_logits, fake_logits, config)
        parameters = list(discriminator.parameters())
        _apply(
            state.discriminator_optimizer, parameters,
            parallel.all_reduce_mean(
                _gradients(total, parameters), state.mesh))
        metrics['loss/discriminator/total'] = total.detach()
        for i, value in enumerate(real_losses):
            metrics[f'loss/discriminator/real-{i:02d}'] = value.detach()
        for i, value in enumerate(fake_losses):
            metrics[f'loss/discriminator/fake-{i:02d}'] = value.detach()

    # Generator, through the updated discriminators
    def losses():
        audio, generated = batch['audio'], work.generated
        total = torch.zeros((), device=audio.device)
        aux = {}
        if config.MEL_LOSS:
            mel_loss = loss.mel(batch['spectrograms'], generated, config)
            total = total + config.MEL_LOSS_WEIGHT * mel_loss
            aux['loss/generator/mels'] = mel_loss
        if config.SPECTRAL_CONVERGENCE_LOSS:
            spectral = loss.multi_resolution_spectral_convergence(
                generated, audio)
            total = total + spectral
            aux['loss/generator/spectral-convergence'] = spectral
        if config.SIGNAL_LOSS:
            signal_loss = loss.signal(
                audio.reshape(audio.shape[0], -1),
                generated.reshape(generated.shape[0], -1))
            total = total + config.SIGNAL_LOSS_WEIGHT * signal_loss
            aux['loss/generator/signal'] = signal_loss
        if adversarial:
            _, fake_logits, real_maps, fake_maps = discriminator(
                audio, generated)
            feature_matching = loss.feature_matching(
                real_maps, fake_maps, config)
            total = total + \
                config.FEATURE_MATCHING_LOSS_WEIGHT * feature_matching
            adversarial_loss, adversarial_losses = loss.generator(
                fake_logits, config)
            total = total + config.ADVERSARIAL_LOSS_WEIGHT * adversarial_loss
            aux['loss/generator/feature-matching'] = feature_matching
            for i, value in enumerate(adversarial_losses):
                aux[f'loss/generator/adversarial-{i:02d}'] = value
        work.total, work.aux = total, aux

    parameters = [state.trainable[name] for name in state.names]

    def backward():
        work.gradients = parallel.all_reduce_mean(
            _gradients(work.total, parameters), state.mesh)

    def optimize():
        gradients, metrics = work.gradients, work.metrics
        gradient_max = torch.max(torch.stack([g.max() for g in gradients]))
        gradient_min = torch.min(torch.stack([g.min() for g in gradients]))
        metrics['gradients/max'] = gradient_max
        metrics['gradients/min'] = gradient_min
        if config.GRADIENT_CLIP_GENERATOR is not None:
            bound = config.GRADIENT_CLIP_GENERATOR
            over = torch.maximum(gradient_max, -gradient_min) > bound
            gradients = [
                torch.where(over, torch.clamp(g, -bound, bound), g)
                for g in gradients]
        _apply(state.generator_optimizer, parameters, gradients)

        metrics['loss/generator/total'] = work.total.detach()
        metrics.update(
            {name: value.detach() for name, value in work.aux.items()})

    phases = [('generator', generator)]
    if discriminate:
        phases.append(('discriminator', update_discriminators))
    phases += [('losses', losses), ('backward', backward),
               ('optimizer', optimize)]
    return work, phases


###############################################################################
# In-training evaluation
###############################################################################


def evaluate(directory, step, state, valid_loader, extractors,
             max_batches=None):
    """Validation: DEFAULT_EVALUATION_STEPS items of the validation
    partition (batches of one, padded to their bucket) synthesized with
    the current weights on the inference route, their masked mel loss,
    and their audio preprocessed again and scored against the item's
    features (`evaluate.Metrics`; not under SPECTROGRAM_ONLY, as in the
    JAX package); logged under 'validation/'. The audio and prosody
    figure (`plot.from_features`: the re-extracted features against the
    item's) of the first PLOT_EXAMPLES items go to TensorBoard where it
    imports. Where matplotlib is not installed no figure is drawn, and
    that is said once per run; a figure that fails is reported once per
    run and validation carries on, as in the JAX package. Touches the
    pause protocol's heartbeat once per item."""
    config = state.config
    if max_batches is None:
        max_batches = config.DEFAULT_EVALUATION_STEPS
    figures = _can_draw(state)
    generator = state.generator
    device = state.trainable[state.names[0]].device
    with torch.no_grad():
        generator.load_state_dict(state.effective())
    pitch_model, ppg_model = extractors
    metrics = Metrics(include_wer=False, config=config)
    mel_total, count, audio_logs, figure_logs = 0., 0, {}, {}
    hopsize = config.HOPSIZE
    for i, batch in enumerate(valid_loader):
        if i >= max_batches:
            break
        pause.heartbeat(config)
        length = int(batch['lengths'][0])
        batch = to_device(batch, device)
        with torch.inference_mode():
            previous_samples = previous_samples_of(batch, config)
            generated = generator(
                *generator_args(batch, config),
                **({} if previous_samples is None else
                   {'previous_samples': previous_samples}))
            mask = torch.arange(
                batch['spectrograms'].shape[-1], device=device) < length
            mel_total += float(loss_module.mel(
                batch['spectrograms'], generated, config, mask[None]))
        count += 1
        if config.SPECTROGRAM_ONLY:
            continue
        waveform = generated[0, :, :length * hopsize].float()
        with torch.inference_mode():
            predicted = preprocess.from_audio(
                waveform, pitch_model, ppg_model,
                features=('loudness', 'pitch', 'periodicity', 'ppg'),
                loudness_bands=None, config=config, device=device)
        metrics.update(
            batch['loudness'][0, :, :length].mean(dim=-2),
            predicted[0].mean(dim=-2)[..., :length],
            batch['pitch'][0, :length],
            batch['periodicity'][0, :length],
            predicted[1][..., :length],
            predicted[2][..., :length],
            batch['ppg'][0, :, :length],
            predicted[3][..., :length])
        if i < config.PLOT_EXAMPLES:
            stem = batch['stems'][0].replace('/', '-')
            audio_logs[f'audio/{stem}'] = waveform.cpu().numpy()
            if figures:
                figure = _prosody_figure(state, stem, waveform, predicted,
                                         batch, length)
                if figure is not None:
                    figure_logs[f'prosody/{stem}'] = figure
    if not count:
        return
    scalars = {'validation/mels': mel_total / count}
    for name, value in ({} if config.SPECTROGRAM_ONLY else metrics()).items():
        if isinstance(value, dict):
            for sub, subvalue in value.items():
                scalars[f'validation/{sub}'] = subvalue
        else:
            scalars[f'validation/{name}'] = value
    log.update(
        directory, step, scalars=scalars, audio=audio_logs,
        sample_rate=config.SAMPLE_RATE, figures=figure_logs)


def _can_draw(state):
    """Whether matplotlib imports; where it does not, say so once per run"""
    import importlib.util
    if importlib.util.find_spec('matplotlib') is not None:
        return True
    if 'no matplotlib' not in state.notes:
        state.notes.add('no matplotlib')
        print('promonet_tpu_torch: matplotlib is not installed; validation '
              'draws no prosody figures', file=sys.stderr)
    return False


def _prosody_figure(state, stem, waveform, predicted, batch, length):
    """The prosody figure of one validation item, or None when drawing it
    raised (reported once per run)"""
    try:
        return plot.from_features(
            audio=waveform, loudness=predicted[0], pitch=predicted[1],
            periodicity=predicted[2], ppg=predicted[3],
            target_pitch=batch['pitch'][0, :length],
            target_periodicity=batch['periodicity'][0, :length],
            target_loudness=batch['loudness'][0, :, :length],
            config=state.config)
    except Exception as error:
        if 'figure failed' not in state.notes:
            state.notes.add('figure failed')
            print(f'prosody figure for {stem} failed (suppressing further '
                  f'reports): {error!r}', file=sys.stderr)
            traceback.print_exc()
        return None
