"""The port's training of the pitch CNN held against the JAX package's,
and what the three extractors' trainings share (the corpus, the record of
the JAX side's jitted calls, the optimizers, the bounds), which
`test_torch_extractor_ppg.py` and `test_torch_extractor_speaker.py`
import.

One tiny formant corpus (2 speakers x 3 utterances x 1 s), written by the
port's `data.synthetic.create` (bit-equal to the JAX package's) and read
by both packages: the JAX package's `CACHE_DIR` is monkeypatched to it
and its `train` writes to `output=` under the test's temporary
directory, so the shipped checkpoints in `promonet_tpu/assets` must be
byte for byte what they were. Each training runs STEPS steps on both
sides from the same initial weights: the JAX package's own
initialisation, read from its first jitted step's arguments and carried
into the port through `models.bridge` by standing in for
`models.init.seeded`. The JAX side's jitted functions are recorded
(inputs and outputs by name) by wrapping `jax.jit` for the call, which
changes nothing they compute.

Tolerances:
- numpy on identical inputs, equal: `_tone_frames`, the frame bank and
  its bf16 cast, bins, voicing, the held-out split, every batch's
  indices, and the held-out figures computed from the JAX run's own
  posteriors;
- gradients: `jax.grad` of the JAX loss and autograd of the port's, on
  the same weights and batch, both in float64 (a ReLU input within
  float32 rounding of zero takes either side in float32, and its whole
  gradient with it), within 1e-5 of each leaf's largest magnitude;
- each step's float32 loss within 1e-5 relative;
- the saved float32 weights after STEPS steps: every element within
  2 * sum(lr_t) + 1e-6 of the JAX package's (no two Adam runs from one
  start can part by more, as each step moves an element by at most lr_t
  plus the decay), and 99% of the elements within 1e-6 (an element whose
  gradient is within rounding of zero may step the other way);
- the optimizers against optax in float64, five steps: within 1e-12;
- a short run's held-out figures against bounds only (finite, in range).
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import promonet_tpu
from promonet_tpu.preprocess import pitch as jax_pitch

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge, init
from promonet_tpu_torch.preprocess import training

STEPS = 2
SEED = promonet_tpu.RANDOM_SEED
CORPUS = dict(speakers=2, utterances=3, seconds=1.0)
SHIPPED = promonet_tpu.ASSETS_DIR / 'checkpoints'


###############################################################################
# What the three extractor files share
###############################################################################


def shipped_checkpoints():
    """{file: sha256} of the JAX package's shipped checkpoints"""
    return {
        str(path.relative_to(SHIPPED)): hashlib.sha256(
            path.read_bytes()).hexdigest()
        for path in sorted(SHIPPED.rglob('*')) if path.is_file()}


def make_corpus(tmp_path_factory, name):
    """The corpus under a new temporary directory, the port's config
    pointing there, the JAX package's CACHE_DIR monkeypatched to it;
    returns (root, config, the patch, the shipped checkpoints' hashes)"""
    root = tmp_path_factory.mktemp(name)
    config = port.config.load().replace(
        CACHE_DIR=root / 'cache', PARTITIONS_DIR=root / 'partitions',
        CHECKPOINTS_DIR=root / 'checkpoints')
    shipped = shipped_checkpoints()
    port.data.synthetic.create(
        'synthetic', **CORPUS, preprocess=False, config=config, device='cpu')
    patch = pytest.MonkeyPatch()
    patch.setattr(promonet_tpu, 'CACHE_DIR', root / 'cache')
    return root, config, patch, shipped


class Recorder:
    """`jax.jit` that keeps each call's inputs and outputs by the jitted
    function's name"""

    def __init__(self):
        self.calls = {}
        self.jit = jax.jit

    def __call__(self, function=None, **kwargs):
        jitted = self.jit(function, **kwargs)

        def call(*args):
            out = jitted(*args)
            self.calls.setdefault(function.__name__, []).append((args, out))
            return out

        return call


def run_jax(train, output, **kwargs):
    """The JAX package's `train` for STEPS steps into `output`; returns
    its result and its recorded jitted calls"""
    recorder = Recorder()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax, 'jit', recorder)
        result = train('synthetic', steps=STEPS, output=output, **kwargs)
    return result, recorder.calls


def run_port(train, initial, config, output, **kwargs):
    """The port's `train` on the CPU for STEPS steps, `init.seeded`
    loading the state dict `initial`; returns its result and each step's
    loss"""
    losses = []

    def seeded(module, seed):
        module.load_state_dict(initial)
        return module

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(init, 'seeded', seeded)
        result = train(
            'synthetic', steps=STEPS, output=output, config=config,
            device='cpu', callback=lambda step, loss: losses.append(
                float(loss)), **kwargs)
    return result, losses


def wide(tree):
    """A JAX parameter tree in float64"""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def assert_gradients(ours, theirs):
    """{name: tensor} against {name: tensor}: within 1e-5 of each leaf's
    largest magnitude"""
    assert set(ours) == set(theirs)
    for name, value in theirs.items():
        scale = float(value.abs().max())
        error = float((ours[name].float() - value).abs().max())
        assert error <= 1e-5 * scale, (name, error, scale)


def assert_losses(ours, calls, loss_of=lambda out: out[-1]):
    theirs = [float(loss_of(out)) for _, out in calls['step_fn']]
    assert len(ours) == len(theirs) == STEPS
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def assert_weights(ours, theirs, learning_rate, schedule=True):
    """Saved weights after STEPS steps against the JAX package's"""
    rates = [learning_rate * (
        .5 * (1 + np.cos(np.pi * step / STEPS)) if schedule else 1.)
        for step in range(STEPS)]
    assert set(ours) == set(theirs)
    errors = []
    for name, value in theirs.items():
        error = (ours[name] - value).abs()
        assert float(error.max()) <= 2 * sum(rates) * (1 + 1e-3) + 1e-6, name
        errors.append(error.flatten())
    errors = torch.cat(errors)
    assert float((errors <= 1e-6).float().mean()) >= .99


def saved(directory, name):
    return port.utils.checkpoint.load(directory / f'{name}-{STEPS:08d}.pt')


###############################################################################
# The optimizers
###############################################################################


def _optimizer_steps(optimizer, schedule, parameter, gradients):
    for gradient in gradients:
        parameter.grad = torch.from_numpy(gradient)
        optimizer.step()
        if schedule is not None:
            schedule.step()
    return parameter.detach().numpy()


@pytest.mark.parametrize('kind', ['adamw_cosine', 'adam'])
def test_optimizers_step_as_optax(kind):
    """Large weights and a large rate, so that the decay and the schedule
    move the weights visibly; float64 on both sides"""
    rng = np.random.default_rng(7)
    start = 3 * rng.standard_normal(64)
    gradients = [rng.standard_normal(64) * 10. ** rng.uniform(-9, 1, 64)
                 for _ in range(5)]
    parameter = torch.nn.Parameter(torch.from_numpy(start.copy()))
    if kind == 'adamw_cosine':
        reference = optax.adamw(
            optax.cosine_decay_schedule(.1, 4), weight_decay=1e-2)
        optimizer, schedule = training.adamw_cosine(
            [parameter], .1, 4, weight_decay=1e-2)
    else:
        reference = optax.adam(.1)
        optimizer = torch.optim.Adam(
            [parameter], lr=.1, betas=(.9, .999), eps=1e-8)
        schedule = None
    ours = _optimizer_steps(optimizer, schedule, parameter, gradients)
    with jax.enable_x64(True):
        params = jnp.asarray(start)
        state = reference.init(params)
        for gradient in gradients:
            updates, state = reference.update(
                jnp.asarray(gradient), state, params)
            params = optax.apply_updates(params, updates)
        theirs = np.asarray(params)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


###############################################################################
# The pitch CNN
###############################################################################


PITCH = dict(batch_size=8, learning_rate=2e-4, max_frames=200,
             tone_fraction=0.4)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root, config, patch, shipped = make_corpus(
        tmp_path_factory, 'pitch-training')
    yield root, config, shipped
    patch.undo()


@pytest.fixture(scope='module')
def runs(corpus):
    """The JAX package's and the port's trainings, from the same weights"""
    root, config, _ = corpus
    jax_result, calls = run_jax(
        jax_pitch.train, root / 'jax' / 'pitch', **PITCH)
    initial = bridge.pitch_state_dict(calls['step_fn'][0][0][0])
    port_result, losses = run_port(
        port.preprocess.pitch.train, initial, config, root / 'port',
        **PITCH)
    return jax_result, calls, port_result, losses


def test_tone_frames_are_bit_equal():
    config = port.config.load()
    theirs_rng, ours_rng = (np.random.default_rng(5) for _ in range(2))
    theirs = jax_pitch._tone_frames(theirs_rng, 700, 1024, 256)
    ours = port.preprocess.pitch._tone_frames(
        ours_rng, 700, 1024, 256, config)
    for mine, reference in zip(ours, theirs):
        assert mine.dtype == reference.dtype
        assert np.array_equal(mine, reference)
    # Both generators are left in the same state
    assert theirs_rng.random() == ours_rng.random()


def test_pitch_bank_split_and_batches_equal_jax(corpus, runs):
    _, config, _ = corpus
    _, calls, _, _ = runs
    rng = np.random.default_rng(SEED)
    frames, bins, voiced, speech = port.preprocess.pitch.training_examples(
        rng, 'synthetic', PITCH['max_frames'], PITCH['tone_fraction'],
        config)
    assert speech.sum() < len(speech) and voiced[~speech].all()
    # The bank as both hold it: bf16, uploaded once
    args = calls['step_fn'][0][0]
    assert np.array_equal(
        torch.from_numpy(frames).bfloat16().float().numpy(),
        np.asarray(args[2]).astype(np.float32))
    assert np.array_equal(bins, np.asarray(args[3]))
    # The split, and each step's indices, drawn after the bank
    order = rng.permutation(len(frames))
    valid, train = np.split(order, [max(1, len(frames) // 20)])
    train_voiced = train[voiced[train]]
    assert len(calls['step_fn']) == STEPS
    for args, _ in calls['step_fn']:
        assert np.array_equal(
            np.asarray(args[4]), rng.choice(train_voiced, PITCH['batch_size']))
    # The held-out inference reads the first len(valid) of its indices
    assert np.array_equal(
        np.asarray(calls['infer'][0][0][2])[:len(valid)], valid)


def test_pitch_gradients_match_jax(runs):
    """At each step's weights and batch of the JAX run"""
    _, calls, _, _ = runs
    module = jax_pitch.PitchCNN.Model()
    model = port.preprocess.PitchCNN()
    for args, _ in calls['step_fn']:
        params, bank, bank_bins, index = args[0], args[2], args[3], args[4]
        frames = np.asarray(bank)[np.asarray(index)].astype(np.float64)
        targets = np.asarray(bank_bins)[np.asarray(index)]
        with jax.enable_x64(True):
            def loss(params):
                return optax.softmax_cross_entropy_with_integer_labels(
                    module.apply(params, jnp.asarray(frames)),
                    jnp.asarray(targets)).mean()
            theirs = jax.device_get(jax.grad(loss)(wide(params)))
        model.load_state_dict(bridge.pitch_state_dict(params))
        model.double().zero_grad()
        port.preprocess.pitch.training_loss(
            model, torch.from_numpy(frames),
            torch.from_numpy(targets.astype(np.int64))).backward()
        model.float()
        assert_gradients(
            {name: parameter.grad
             for name, parameter in model.named_parameters()},
            bridge.pitch_state_dict(theirs))


def test_pitch_steps_match_jax(corpus, runs):
    root, _, _ = corpus
    _, calls, _, losses = runs
    assert_losses(losses, calls)
    theirs = promonet_tpu.utils.checkpoint.load(root / 'jax' / 'pitch')
    assert_weights(
        saved(root / 'port', 'pitch')['params'],
        bridge.pitch_state_dict(theirs['params']), PITCH['learning_rate'])


def test_pitch_held_out_figures_equal_jax_given_its_posteriors(
        corpus, runs):
    root, config, _ = corpus
    (cents, voicing), calls, _, _ = runs
    rng = np.random.default_rng(SEED)
    _, bins, voiced, speech = port.preprocess.pitch.training_examples(
        rng, 'synthetic', PITCH['max_frames'], PITCH['tone_fraction'],
        config)
    valid = rng.permutation(len(bins))[:max(1, len(bins) // 20)]
    decoded, confidence = (
        np.asarray(value)[:len(valid)] for value in calls['infer'][0][1])
    theirs = promonet_tpu.utils.checkpoint.load(root / 'jax' / 'pitch')
    assert port.preprocess.pitch.held_out_figures(
        decoded, confidence, bins[valid], voiced[valid], speech[valid],
        config) == (cents, float(theirs['voicing_threshold']), voicing)


def test_pitch_checkpoint_is_read_by_load(corpus, runs):
    root, config, shipped = corpus
    _, _, (cents, voicing), _ = runs
    payload = saved(root / 'port', 'pitch')
    assert payload['step'] == STEPS
    # Two steps on six utterances: bounds, not the JAX run's figures
    assert 0. <= cents <= 1200 * np.log2(config.FMAX / config.FMIN)
    assert 0. <= voicing <= 1.
    assert (payload['median_cents'], payload['voicing_accuracy']) == (
        cents, voicing)
    model = port.load.pitch_model(
        config=config.replace(CHECKPOINTS_DIR=root / 'port'), device='cpu')
    assert model.voicing_threshold == payload['voicing_threshold']
    for name, value in model.state_dict().items():
        assert torch.equal(value, payload['params'][name])
    assert shipped_checkpoints() == shipped


def test_pitch_training_without_a_card_raises(corpus, monkeypatch):
    _, config, _ = corpus
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.preprocess.pitch.train('synthetic', steps=1, config=config)
