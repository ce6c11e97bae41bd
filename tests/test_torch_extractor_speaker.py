"""The port's training of the speaker encoder held against the JAX
package's

The corpus, the two runs and the tolerances are those of
`test_torch_extractor_pitch.py`; the log-mels of the window bank, which
the two packages' FFTs round otherwise, are held within 2e-5 absolute.
The port trains a `preprocess.speaker.Classifier`, the encoder and its
dense head, whose initial weights are the JAX package's encoder and head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import promonet_tpu
from promonet_tpu.preprocess import speaker as jax_speaker

import promonet_tpu_torch as port
from promonet_tpu_torch.models import bridge
from test_torch_extractor_pitch import (
    CORPUS, SEED, STEPS, assert_gradients, assert_losses, assert_weights,
    make_corpus, run_jax, run_port, saved, shipped_checkpoints, wide)

SPEAKER = dict(batch_size=4, window=32, learning_rate=3e-4)
MELS_ATOL = 2e-5


def _classifier_state(params, head):
    """The JAX encoder's and head's parameters as a `Classifier` state"""
    head = head['params'] if set(head) == {'params'} else head
    state = {f'encoder.{name}': value
             for name, value in bridge.speaker_state_dict(params).items()}
    state['head.weight'] = torch.from_numpy(
        np.array(head['kernel'], np.float32).T.copy())
    state['head.bias'] = torch.from_numpy(np.array(head['bias'], np.float32))
    return state


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root, config, patch, shipped = make_corpus(
        tmp_path_factory, 'speaker-training')
    yield root, config, shipped
    patch.undo()


@pytest.fixture(scope='module')
def runs(corpus):
    """The JAX package's and the port's trainings, from the same weights"""
    root, config, _ = corpus
    jax_result, calls = run_jax(
        jax_speaker.train, root / 'jax' / 'speaker', **SPEAKER)
    first = calls['step_fn'][0][0]
    port_result, losses = run_port(
        port.preprocess.speaker.train, _classifier_state(first[0], first[1]),
        config, root / 'port', **SPEAKER)
    return jax_result, calls, port_result, losses


def test_speaker_bank_split_and_batches_equal_jax(corpus, runs):
    _, config, _ = corpus
    _, calls, _, _ = runs
    mels, labels, lengths, speakers = \
        port.preprocess.speaker.training_examples(
            'synthetic', SPEAKER['window'], config, 'cpu')
    assert speakers == ['0000', '0001']
    assert len(calls['mels_of']) == CORPUS['speakers'] * CORPUS['utterances']
    # Each window's log-mels against the JAX package's of its utterance
    theirs = [np.asarray(out) for _, out in calls['mels_of']]
    window = SPEAKER['window']
    kept = [mel[start:start + window] for mel in theirs
            for start in range(0, len(mel), window)]
    assert len(kept) >= len(mels)
    rng = np.random.default_rng(SEED)
    order = rng.permutation(len(mels))
    num_valid = max(1, len(mels) // 20)
    checked = [(rng.choice(order[num_valid:], SPEAKER['batch_size']),
                args[3:]) for args, _ in calls['step_fn']]
    checked.append((order[:num_valid], calls['accuracy_fn'][-1][0][2:]))
    assert len(checked) == STEPS + 1
    for index, (their_mels, their_labels, their_lengths) in checked:
        assert np.array_equal(labels[index], np.asarray(their_labels))
        assert np.array_equal(lengths[index], np.asarray(their_lengths))
        np.testing.assert_allclose(
            mels[index], np.asarray(their_mels), rtol=0, atol=MELS_ATOL)


def test_speaker_gradients_match_jax(runs):
    """At each step's weights and batch of the JAX run, encoder and head"""
    _, calls, _, _ = runs
    import flax.linen as nn
    encoder = jax_speaker.SpeakerEncoder().module
    head = nn.Dense(2)
    model = port.preprocess.speaker.Classifier(2)
    for args, _ in calls['step_fn']:
        params, head_params = args[0], args[1]
        mels, labels, counts = (np.asarray(value) for value in args[3:])
        with jax.enable_x64(True):
            def loss(both):
                logits = head.apply(both[1], encoder.apply(
                    both[0], jnp.asarray(mels, 'float64'),
                    jnp.asarray(counts)))
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, jnp.asarray(labels)).mean()
            theirs = jax.device_get(
                jax.grad(loss)((wide(params), wide(head_params))))
        model.load_state_dict(_classifier_state(params, head_params))
        model.double().zero_grad()
        port.preprocess.speaker.training_loss(
            model, torch.from_numpy(mels.astype(np.float64)),
            torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(counts.astype(np.int64))).backward()
        model.float()
        assert_gradients(
            {name: parameter.grad
             for name, parameter in model.named_parameters()},
            _classifier_state(*theirs))


def test_speaker_steps_match_jax(corpus, runs):
    root, _, _ = corpus
    _, calls, _, losses = runs
    assert_losses(losses, calls)
    theirs = promonet_tpu.utils.checkpoint.load(root / 'jax' / 'speaker')
    assert_weights(
        saved(root / 'port', 'speaker')['params'],
        bridge.speaker_state_dict(theirs['params']),
        SPEAKER['learning_rate'], schedule=False)


def test_speaker_checkpoint_is_read_by_load(corpus, runs):
    root, config, shipped = corpus
    _, _, accuracy, _ = runs
    payload = saved(root / 'port', 'speaker')
    # Only the encoder is kept; two steps give a bound, not a figure
    assert not any(name.startswith('head') for name in payload['params'])
    assert 0. <= accuracy <= 1. and payload['accuracy'] == accuracy
    encoder = port.load.speaker_encoder(
        config=config.replace(CHECKPOINTS_DIR=root / 'port'), device='cpu')
    for name, value in encoder.state_dict().items():
        assert torch.equal(value, payload['params'][name])
    assert shipped_checkpoints() == shipped


def test_speaker_training_without_a_card_raises(corpus, monkeypatch):
    _, config, _ = corpus
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        port.preprocess.speaker.train('synthetic', steps=1, config=config)
