"""The port's CUDA kernels held against their plain PyTorch versions.

These need an NVIDIA GPU and `nvcc`; elsewhere they skip. This file
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the Viterbi paths (both kernels) are equal exactly. The bfloat16 residual
block is bounded per element by 2^-5 * (|plain| + 2 * rms(plain)): four
bf16 ulps relative to the element, with a floor at twice the output's
RMS, because where the residual add cancels, a rounding flipped early in
the chain leaves an error at the scale of the operands (seen on the
card: 0.0625 on an element below 1, RMS 1.4). chip_smoke.py uses the
same bound and checks that a zeroed bias breaks it.
"""
import numpy as np
import pytest
import torch

from promonet_tpu_torch.ops import resblock, viterbi

pytestmark = pytest.mark.cuda

DILATIONS = (1, 3, 5)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('frames', [1, 2, 37, 896])
def test_viterbi_kernel_matches_plain(device, frames):
    rng = np.random.default_rng(frames)
    observation = torch.log_softmax(
        torch.from_numpy(3 * rng.standard_normal((frames, 256))).float(), -1)
    transition = viterbi.triangular_transition(256, 9.)
    initial = torch.full((256,), -float(np.log(np.float32(256))))
    plain = viterbi.decode(observation, transition, initial)
    launches = viterbi.decode.launches
    kernel = viterbi.decode(
        observation.to(device), transition.to(device), initial.to(device))
    assert viterbi.decode.launches == launches + 1
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_viterbi_kernel_breaks_ties_to_the_first_index(device):
    rng = np.random.default_rng(0)
    observation = torch.from_numpy(
        np.round(rng.standard_normal((300, 256)))).float()
    transition = torch.zeros(256, 256)
    initial = torch.zeros(256)
    plain = viterbi.decode(observation, transition, initial)
    kernel = viterbi.decode(
        observation.to(device), transition.to(device), initial.to(device))
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def _stft_axis():
    """The harmonics path's frequency axis: 2039 bins from FMIN to Nyquist"""
    frequencies = np.abs(np.fft.fftfreq(4096, 1 / 22050)[:2049])
    return frequencies[int(np.searchsorted(frequencies, 50.)):].astype(
        np.float32)


def _logfreq_observation(kind, frames, states, seed):
    rng = np.random.default_rng(seed)
    if kind == 'ties':
        return torch.from_numpy(
            np.round(rng.standard_normal((frames, states)))).float()
    logits = torch.from_numpy(
        3 * rng.standard_normal((frames, states))).float()
    if kind in ('masked', 'nan'):
        low = torch.from_numpy(rng.integers(0, states - 30, frames))[:, None]
        columns = torch.arange(states)[None]
        logits = torch.where(
            (columns >= low) & (columns < low + 25), logits, -float('inf'))
    observation = torch.log_softmax(logits, -1)
    if kind == 'nan':
        observation[frames // 2] = float('nan')
    return observation


@pytest.mark.parametrize('kind', ['random', 'ties', 'masked', 'nan'])
@pytest.mark.parametrize('frames,states', [
    (1, 200), (2, 200), (70, 200), (33, 2039), (70, 31), (5, 512)])
def test_logfreq_kernel_matches_plain(device, kind, frames, states):
    frequencies = _stft_axis() if states == 2039 else \
        np.linspace(50., 8000., states)
    observation = _logfreq_observation(kind, frames, states, frames + states)
    initial = torch.log_softmax(
        torch.linspace(0., -5., states), -1)
    plain = viterbi.decode_logfreq(observation, frequencies, initial)
    launches = viterbi.decode_logfreq.launches
    kernel = viterbi.decode_logfreq(
        observation.to(device), frequencies, initial.to(device))
    torch.cuda.synchronize()
    assert viterbi.decode_logfreq.launches == launches + 1
    assert kernel.dtype == torch.int32 and kernel.shape == (frames,)
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_logfreq_kernel_keeps_the_first_of_sums_that_round_together(device):
    """Alphas one float32 step apart whose sums with the floor coincide"""
    rng = np.random.default_rng(4)
    observation = torch.zeros(70, 200)
    observation[0] = -4300.
    observation[0, 40:52] = torch.from_numpy(
        np.float32(-4090.) -
        rng.integers(1, 4, 12) * np.float32(2. ** -12))
    observation[1:] = torch.from_numpy(
        np.round(rng.standard_normal((69, 200)))).float()
    observation[1, 150] = 200.
    frequencies = np.linspace(50., 8000., 200)
    initial = torch.zeros(200)
    plain = viterbi.decode_logfreq(observation, frequencies, initial)
    kernel = viterbi.decode_logfreq(
        observation.to(device), frequencies, initial.to(device))
    assert plain[0] == 43
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_logfreq_kernel_rejects_what_it_does_not_take(device):
    frequencies = np.linspace(50., 8000., 200)
    observation = torch.zeros(4, 200, device=device)
    initial = torch.zeros(200, device=device)
    with pytest.raises(ValueError, match='float32'):
        viterbi.decode_logfreq(observation.double(), frequencies, initial)
    with pytest.raises(ValueError, match='frequencies'):
        viterbi.decode_logfreq(observation, frequencies[:100], initial)
    with pytest.raises(ValueError, match='initial'):
        viterbi.decode_logfreq(observation, frequencies, initial.cpu())
    # A block's slice of the band table must fit in shared memory
    with pytest.raises(ValueError, match='too long'):
        viterbi.decode_logfreq(
            torch.zeros(2, 6000, device=device),
            np.linspace(50., 8000., 6000),
            torch.zeros(6000, device=device))


@pytest.mark.parametrize('channels,kernel_size', [
    (256, 3), (128, 7), (64, 11), (32, 11)])
@pytest.mark.parametrize('batch,frames', [(1, 1000), (4, 333)])
def test_resblock_kernel_matches_plain(
    device, batch, frames, channels, kernel_size
):
    rng = np.random.default_rng(channels + kernel_size + batch)
    weights = torch.from_numpy(
        rng.standard_normal((6, kernel_size, channels, channels)) /
        np.sqrt(kernel_size * channels)).to(device, torch.bfloat16)
    biases = torch.from_numpy(
        0.1 * rng.standard_normal((6, channels))).float().to(device)
    x = torch.from_numpy(rng.standard_normal(
        (batch, frames, channels))).to(device, torch.bfloat16)
    plain = resblock.reference_block(
        x, weights, biases, DILATIONS, 0.1, torch.bfloat16).float()
    launches = resblock.fused_block.launches
    kernel = resblock.fused_block(x, weights, biases, DILATIONS, 0.1).float()
    torch.cuda.synchronize()
    assert resblock.fused_block.launches == launches + 1
    floor = 2 * plain.pow(2).mean().sqrt()
    assert torch.all(
        (kernel - plain).abs() <= 2. ** -5 * (plain.abs() + floor)).item()
