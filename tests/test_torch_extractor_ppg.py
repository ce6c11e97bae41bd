"""The port's training of the PPG encoder held against the JAX package's

The corpus, the two runs and the tolerances are those of
`test_torch_extractor_pitch.py`; the log-mels of the window bank, which
the two packages' FFTs round otherwise, are held within 2e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import promonet_tpu
from promonet_tpu.preprocess import ppg as jax_ppg

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from test_torch_extractor_pitch import (
    SEED, STEPS, assert_gradients, assert_losses, assert_weights,
    make_corpus, run_jax, run_port, saved, shipped_checkpoints, wide)

PPG = dict(batch_size=4, window=32, learning_rate=1e-3)
MELS_ATOL = 2e-5


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root, config, patch, shipped = make_corpus(
        tmp_path_factory, 'ppg-training')
    yield root, config, shipped
    patch.undo()


@pytest.fixture(scope='module')
def runs(corpus):
    """The JAX package's and the port's trainings, from the same weights"""
    root, config, _ = corpus
    jax_result, calls = run_jax(jax_ppg.train, root / 'jax' / 'ppg', **PPG)
    initial = bridge.ppg_state_dict(calls['step_fn'][0][0][0])
    port_result, losses = run_port(
        port.preprocess.ppg.train, initial, config, root / 'port', **PPG)
    return jax_result, calls, port_result, losses


def _split_and_batches(count):
    rng = np.random.default_rng(SEED)
    order = rng.permutation(count)
    num_valid = max(2, count // 20)
    batches = [rng.choice(order[num_valid:], PPG['batch_size'])
               for _ in range(STEPS)]
    return order[:num_valid], batches


def test_ppg_bank_split_and_batches_equal_jax(corpus, runs):
    _, config, _ = corpus
    _, calls, _, _ = runs
    mels, labels, masks = port.preprocess.ppg.training_examples(
        'synthetic', PPG['window'], config, 'cpu')
    # Every utterance's log-mels, zero-padded to whole windows
    theirs = np.concatenate([np.asarray(out) for _, out in calls['mels_of']])
    assert theirs.shape == (len(mels) * PPG['window'], config.NUM_MELS)
    np.testing.assert_allclose(
        mels.reshape(theirs.shape), theirs, rtol=0, atol=MELS_ATOL)
    assert 0 < masks.sum() < masks.size
    # Each step's batch and the held-out windows: labels and masks equal
    valid, batches = _split_and_batches(len(mels))
    checked = [(index, args[2:]) for index, (args, _) in zip(
        batches, calls['step_fn'])]
    checked.append((valid, calls['accuracy_fn'][-1][0][1:]))
    assert len(checked) == STEPS + 1
    for index, (their_mels, their_labels, their_masks) in checked:
        assert np.array_equal(labels[index], np.asarray(their_labels))
        assert np.array_equal(masks[index], np.asarray(their_masks))
        np.testing.assert_allclose(
            mels[index], np.asarray(their_mels), rtol=0, atol=MELS_ATOL)


def test_ppg_gradients_match_jax(runs):
    """At each step's weights and batch of the JAX run"""
    _, calls, _, _ = runs
    module = jax_ppg.PPGEncoder(num_phonemes=40, dtype=jnp.float64)
    model = port.preprocess.PPGEncoder()
    for args, _ in calls['step_fn']:
        params, mels, labels, mask = (
            args[0], *(np.asarray(value) for value in args[2:]))
        with jax.enable_x64(True):
            def loss(params):
                log_probs = module.apply(params, jnp.asarray(mels, 'float64'))
                nll = -jnp.take_along_axis(
                    log_probs, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
                return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.)
            theirs = jax.device_get(jax.grad(loss)(wide(params)))
        model.load_state_dict(bridge.ppg_state_dict(params))
        model.double().zero_grad()
        port.preprocess.ppg.training_loss(
            model, torch.from_numpy(mels.astype(np.float64)),
            torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(mask.astype(np.float64))).backward()
        model.float()
        assert_gradients(
            {name: parameter.grad
             for name, parameter in model.named_parameters()},
            bridge.ppg_state_dict(theirs))


def test_ppg_steps_match_jax(corpus, runs):
    root, _, _ = corpus
    _, calls, _, losses = runs
    assert_losses(losses, calls)
    theirs = promonet_tpu.utils.checkpoint.load(root / 'jax' / 'ppg')
    assert_weights(
        saved(root / 'port', 'ppg')['params'],
        bridge.ppg_state_dict(theirs['params']), PPG['learning_rate'])


def test_ppg_checkpoint_is_read_by_load(corpus, runs):
    root, config, shipped = corpus
    _, _, accuracy, _ = runs
    payload = saved(root / 'port', 'ppg')
    # Two steps: a bound, not the JAX run's figure
    assert 0. <= accuracy <= 1. and payload['accuracy'] == accuracy
    model = port.load.ppg_model(
        config=config.replace(CHECKPOINTS_DIR=root / 'port'), device='cpu')
    for name, value in model.state_dict().items():
        assert torch.equal(value, payload['params'][name])
    assert shipped_checkpoints() == shipped


def test_ppg_training_without_a_card_raises(corpus, monkeypatch):
    _, config, _ = corpus
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.preprocess.ppg.train('synthetic', steps=1, config=config)
