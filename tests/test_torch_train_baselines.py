"""The Vocos and spectrogram-only generators' training steps held against
the JAX package's: one step from `create_state` with the narrow
configuration and tolerances of `test_torch_train.py` (step 1), under
configs/baselines/vocos.py's AdamW betas and configs/baselines/mels.py's
SPECTROGRAM_ONLY.
"""
import pytest

from test_torch_train import (
    LR, _assert_first_step_matches, _config, _jax_steps, _run_port_step)


@pytest.mark.parametrize('generator', ['vocos', 'mels'])
def test_first_step_of_the_baselines_matches_jax(generator):
    """The Vocos backbone (configs/baselines/vocos.py: its AdamW betas)
    and the spectrogram-only generator (configs/baselines/mels.py)"""
    overrides = dict(
        vocos=dict(MODEL='vocos', OPTIMIZER={
            'name': 'adamw', 'lr': LR, 'b1': .9, 'b2': .999, 'eps': 1e-9,
            'weight_decay': 1e-2}),
        mels=dict(SPECTROGRAM_ONLY=True))[generator]
    states, metrics = _jax_steps('float32', 1, **overrides)
    ours = _run_port_step(states[0], _config(**overrides), 0)
    assert type(ours[0].generator).__name__ == (
        'MelGenerator' if generator == 'mels' else 'Generator')
    _assert_first_step_matches(states, metrics, *ours)
