"""The port's CUDA kernels held against their plain PyTorch versions.

These need an NVIDIA GPU and `nvcc`; elsewhere they skip. This file
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: the Viterbi paths are equal exactly. The bfloat16 residual
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
