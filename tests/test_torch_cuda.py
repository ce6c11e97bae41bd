"""The port's CUDA kernels held against their plain PyTorch versions, and
on the paths that call them: zero-shot batches (K1 at B = 8 with x-vector
speakers), the three CLIs as processes of their own, the registered
residual-block operator inside an exported program, CARGAN, FARGAN's
training step (no K1; the card against the CPU with the same noise),
`ops.viterbi.from_probabilities` (K2), the pitch decode first made under
`torch.inference_mode` (K2), one training step of each
feature extractor (the card against the CPU), the resident corpus'
gather and draws on the card against the CPU, a resident training step
(no K1), the pause's drain (the card idle before the acknowledgement),
and one NCCL rank's step against the same step without the group.

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
from pathlib import Path

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


def test_pitch_decode_first_made_under_inference_mode(device):
    """A process whose first pitch decode runs under torch.inference_mode,
    as a training run's validation does, decodes through K2 and as a
    decode outside that mode does"""
    from promonet_tpu_torch.preprocess import pitch
    scores = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (200, 256))).float().to(device)
    pitch.decode_constants.cache_clear()
    launches = viterbi.decode.launches
    with torch.inference_mode():
        first = pitch.decode(scores, 50., 550.)
    assert viterbi.decode.launches == launches + 1
    again = pitch.decode(scores, 50., 550.)
    for ours, theirs in zip(first, again):
        assert torch.equal(ours, theirs)


def _pitch_observation(kind, frames, seed):
    rng = np.random.default_rng(seed)
    observation = torch.log_softmax(torch.from_numpy(
        3 * rng.standard_normal((frames, 256))).float(), -1)
    if kind == 'minus_inf':
        observation[torch.from_numpy(rng.random((frames, 256)) < 0.5)] = \
            -float('inf')
        observation[frames // 3] = -float('inf')
    elif kind == 'nan_frame':
        observation[frames // 2] = float('nan')
    elif kind == 'nan_entry':
        observation[frames // 2, 7] = float('nan')
    elif kind == 'ties':
        observation = torch.round(observation)
    return observation


@pytest.mark.parametrize('transition_kind', [
    'triangular', 'all_equal', 'random_dense'])
@pytest.mark.parametrize('kind', [
    'random', 'ties', 'minus_inf', 'nan_frame', 'nan_entry'])
def test_viterbi_kernel_matches_plain_on_hard_inputs(
    device, kind, transition_kind
):
    """-inf and NaN observations, and transitions with and without a band"""
    observation = _pitch_observation(kind, 150, len(kind))
    transition = {
        'triangular': viterbi.triangular_transition(256, 9.),
        'all_equal': torch.zeros(256, 256),
        'random_dense': torch.from_numpy(np.random.default_rng(2)
                                         .standard_normal((256, 256))).float()
    }[transition_kind]
    initial = torch.full((256,), -float(np.log(np.float32(256))))
    plain = viterbi.decode(observation, transition, initial)
    kernel = viterbi.decode(
        observation.to(device), transition.to(device), initial.to(device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


@pytest.mark.parametrize('frames,states', [
    (4096, 256), (50, 40), (50, 1500), (3, 300)])
def test_viterbi_kernel_takes_any_length_and_width(device, frames, states):
    """Long decodes (several backtrace chunks), fewer states than a warp
    pair, more states than threads (two-byte predecessors)"""
    rng = np.random.default_rng(frames + states)
    observation = torch.log_softmax(torch.from_numpy(
        3 * rng.standard_normal((frames, states))).float(), -1)
    transition = viterbi.triangular_transition(states, 9.)
    initial = torch.zeros(states)
    plain = viterbi.decode(observation, transition, initial)
    kernel = viterbi.decode(
        observation.to(device), transition.to(device), initial.to(device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_viterbi_kernel_decodes_a_batch(device):
    observation = torch.stack([
        _pitch_observation(kind, 200, 9)
        for kind in ('random', 'ties', 'nan_frame')])
    transition = viterbi.triangular_transition(256, 9.)
    initial = torch.full((256,), -float(np.log(np.float32(256))))
    plain = viterbi.decode(observation, transition, initial)
    launches = viterbi.decode.launches
    band = viterbi.banded(transition.to(device))
    kernel = viterbi.decode(observation.to(device), band, initial.to(device))
    torch.cuda.synchronize()
    assert viterbi.decode.launches == launches + 1
    assert kernel.shape == (3, 200) and kernel.dtype == torch.int32
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_viterbi_forward_and_backtrace_run_apart(device):
    observation = _pitch_observation('random', 300, 1).to(device)
    band = viterbi.banded(viterbi.triangular_transition(256, 9.).to(device))
    initial = torch.zeros(256, device=device)
    whole = viterbi.decode(observation, band, initial)
    scratch = viterbi._decode_cuda(observation, band, initial, phases=1)
    apart = viterbi._decode_cuda(
        observation, band, initial, phases=2, scratch=scratch)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(apart.cpu().numpy(), whole.cpu().numpy())


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
    if kind in ('masked', 'nan', 'empty'):
        low = torch.from_numpy(rng.integers(0, states - 30, frames))[:, None]
        columns = torch.arange(states)[None]
        logits = torch.where(
            (columns >= low) & (columns < low + 25), logits, -float('inf'))
    observation = torch.log_softmax(logits, -1)
    if kind == 'nan':
        observation[frames // 2] = float('nan')
    if kind == 'empty':
        observation[frames // 3] = -float('inf')
    return observation


@pytest.mark.parametrize('kind', ['random', 'ties', 'masked', 'nan', 'empty'])
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


def _logfreq_initial(states):
    return torch.log_softmax(torch.linspace(0., -5., states), -1)


@pytest.mark.parametrize('kind', ['nan', 'empty'])
def test_logfreq_kernel_takes_nan_and_empty_band_frames_at_full_width(
    device, kind
):
    """861 frames of the harmonics axis: sixteen blocks, several chunks of
    the backtrace"""
    frequencies = _stft_axis()
    observation = _logfreq_observation(kind, 861, 2039, 11)
    initial = _logfreq_initial(2039)
    plain = viterbi.decode_logfreq(observation, frequencies, initial)
    kernel = viterbi.decode_logfreq(
        observation.to(device), frequencies, initial.to(device))
    torch.cuda.synchronize()
    assert viterbi.logfreq_route(frequencies, device) == ('cluster', 16)
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


@pytest.mark.parametrize('states,frames', [(200, 70), (2039, 40)])
def test_logfreq_kernel_decodes_a_batch(device, states, frames):
    frequencies = _stft_axis() if states == 2039 else \
        np.linspace(50., 8000., states)
    observation = torch.stack([
        _logfreq_observation(kind, frames, states, 5)
        for kind in ('random', 'nan', 'ties')])
    initial = _logfreq_initial(states)
    plain = viterbi.decode_logfreq(observation, frequencies, initial)
    launches = viterbi.decode_logfreq.launches
    kernel = viterbi.decode_logfreq(
        observation.to(device), frequencies, initial.to(device))
    torch.cuda.synchronize()
    assert viterbi.decode_logfreq.launches == launches + 1
    assert kernel.shape == (3, frames) and kernel.dtype == torch.int32
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())
    for sequence, path in zip(observation, kernel):
        single = viterbi.decode_logfreq(
            sequence.to(device), frequencies, initial.to(device))
        np.testing.assert_array_equal(
            single.cpu().numpy(), path.cpu().numpy())


def test_logfreq_kernel_stores_two_byte_predecessors(device):
    """The forward pass alone, then the backtrace alone over its scratch"""
    frequencies = np.linspace(50., 8000., 200)
    observation = _logfreq_observation('masked', 70, 200, 2).to(device)
    initial = _logfreq_initial(200).to(device)
    predecessors, path = viterbi._decode_logfreq_cuda(
        observation, frequencies, initial, 3.5, phases=1)
    torch.cuda.synchronize()
    assert predecessors.dtype == torch.int16 == viterbi.logfreq_entry_dtype(
        200)
    assert predecessors.shape == (1, 70, 200)  # 200 is a multiple of 8
    expected, final_alpha = viterbi.forward_plain(
        observation, viterbi.logfreq_transition_dense(frequencies).to(device),
        initial)
    np.testing.assert_array_equal(
        predecessors[0, 1:].cpu().numpy(), expected[1:].cpu().numpy())
    assert int(path[0, -1]) == int(torch.argmax(final_alpha))
    whole = viterbi.decode_logfreq(observation, frequencies, initial)
    apart = viterbi._decode_logfreq_cuda(
        observation, frequencies, initial, 3.5, phases=2,
        scratch=(predecessors, path))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        apart.cpu().numpy(), whole.cpu().numpy())


@pytest.mark.parametrize('states,blocks', [(200, 1), (200, 4), (2039, 16)])
def test_logfreq_kernel_counts_cycles_on_request(device, states, blocks):
    """The counting variant decodes the same path and fills its counts"""
    frequencies = _stft_axis() if states == 2039 else \
        np.linspace(50., 8000., states)
    observation = _logfreq_observation('masked', 50, states, 6).to(device)
    initial = _logfreq_initial(states).to(device)
    plain = viterbi._decode_logfreq_cuda(
        observation, frequencies, initial, 3.5, route=blocks)
    cycles = torch.zeros(
        (2, len(viterbi.LOGFREQ_SECTIONS)), dtype=torch.int64, device=device)
    counted = viterbi._decode_logfreq_cuda(
        observation, frequencies, initial, 3.5, route=blocks, cycles=cycles)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        counted.cpu().numpy(), plain.cpu().numpy())
    assert (cycles[0] > 0).all()
    with pytest.raises(ValueError, match='cycles'):
        viterbi._decode_logfreq_cuda(
            observation, frequencies, initial, 3.5, cycles=cycles.int())


@pytest.mark.parametrize('kind', ['random', 'masked', 'nan'])
@pytest.mark.parametrize('route', [1, 2, 4, 16, 'grid'])
def test_logfreq_kernel_agrees_on_every_route(device, route, kind):
    """Clusters of every size and the grid route on one axis"""
    frequencies = np.linspace(50., 8000., 200)
    observation = _logfreq_observation(kind, 70, 200, 8)
    initial = _logfreq_initial(200)
    plain = viterbi.decode_logfreq(observation, frequencies, initial)
    routes = dict(viterbi.decode_logfreq.routes)
    kernel = viterbi._decode_logfreq_cuda(
        observation.to(device), frequencies, initial.to(device), 3.5,
        route=route)
    torch.cuda.synchronize()
    taken = 'grid' if route == 'grid' else 'cluster'
    assert viterbi.decode_logfreq.routes[taken] == routes[taken] + 1
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def test_logfreq_route_follows_the_size_of_the_axis(device):
    """One block for 200 states, sixteen for the harmonics axis, the grid
    route where no cluster holds the table"""
    assert viterbi.logfreq_route(
        np.linspace(50., 8000., 200), device) == ('cluster', 1)
    assert viterbi.logfreq_route(_stft_axis(), device) == ('cluster', 16)
    long_axis = np.linspace(50., 8000., 3000)
    assert viterbi.logfreq_route(long_axis, device)[0] == 'grid'
    observation = _logfreq_observation('masked', 30, 3000, 1)
    initial = _logfreq_initial(3000)
    routes = dict(viterbi.decode_logfreq.routes)
    kernel = viterbi.decode_logfreq(
        observation.to(device), long_axis, initial.to(device))
    torch.cuda.synchronize()
    assert viterbi.decode_logfreq.routes['grid'] == routes['grid'] + 1
    plain = viterbi.backtrace_plain(*viterbi.forward_plain(
        observation.to(device),
        viterbi.logfreq_transition_dense(long_axis).to(device),
        initial.to(device)))
    np.testing.assert_array_equal(
        kernel.cpu().numpy(), plain.cpu().numpy())


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
    # No cluster holds this table, and a block of the grid route must fit
    # its slice of it in shared memory
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


def _resblock_problem(device, batch, frames, channels, kernel_size):
    rng = np.random.default_rng(channels + kernel_size + batch + frames)
    weights = torch.from_numpy(
        rng.standard_normal((6, kernel_size, channels, channels)) /
        np.sqrt(kernel_size * channels)).to(device, torch.bfloat16)
    biases = torch.from_numpy(
        0.1 * rng.standard_normal((6, channels))).float().to(device)
    x = torch.from_numpy(rng.standard_normal(
        (batch, frames, channels))).to(device, torch.bfloat16)
    return x, weights, biases


def _within_bound(kernel, plain):
    floor = 2 * plain.pow(2).mean().sqrt()
    return torch.all(
        (kernel - plain).abs() <= 2. ** -5 * (plain.abs() + floor)).item()


@pytest.mark.parametrize('tiles', [1, 2, 4])
@pytest.mark.parametrize('batch,frames,channels,kernel_size', [
    (2, 1000, 48, 7),     # odd width: zero-padded to 64
    (2, 300, 200, 3),     # odd width above 128: two tiles of 128
    (3, 5, 64, 11),       # shorter than the halo
    (2, 70, 128, 11),     # ends inside the second tile's halo
    (1, 64, 32, 3),       # exactly one tile
    (2, 129, 256, 7)])
def test_resblock_kernel_matches_plain_at_odd_shapes(
    device, tiles, batch, frames, channels, kernel_size
):
    if tiles == 4 and channels > 64:
        pytest.skip('four row tiles run up to 64 channels')
    x, weights, biases = _resblock_problem(
        device, batch, frames, channels, kernel_size)
    plain = resblock.reference_block(
        x, weights, biases, DILATIONS, 0.1, torch.bfloat16).float()
    packed = resblock.pack_weights(weights, biases)
    kernel = resblock.fused_block(
        x, packed, None, DILATIONS, 0.1, tiles=tiles).float()
    torch.cuda.synchronize()
    assert kernel.shape == plain.shape
    assert _within_bound(kernel, plain)
    broken = biases.clone()
    broken[5, torch.argmax(broken[5].abs())] = 0.
    wrong = resblock.fused_block(
        x, weights, broken, DILATIONS, 0.1, tiles=tiles).float()
    assert not _within_bound(wrong, plain)


# (T, C) of the four HiFi-GAN stages: at the 1280-frame bucket of the
# main path's edited 10 s, and at the 64-frame window of the Streamer
MAIN_PATH_SHAPES = [(10240, 256), (81920, 128), (163840, 64), (327680, 32)]
STREAM_WINDOW_SHAPES = [(512, 256), (4096, 128), (8192, 64), (16384, 32)]


@pytest.mark.parametrize('kernel_size', [3, 7, 11])
@pytest.mark.parametrize('batch,frames,channels', [
    (8, frames, channels) for frames, channels in MAIN_PATH_SHAPES] + [
    (1, frames, channels) for frames, channels in STREAM_WINDOW_SHAPES])
def test_resblock_kernel_matches_plain_on_the_serving_paths(
    device, batch, frames, channels, kernel_size
):
    """Batched synthesis (eight rows) and the Streamer's window, with the
    weights packed once as `models.hifigan.Block` holds them"""
    x, weights, biases = _resblock_problem(
        device, batch, frames, channels, kernel_size)
    plain = resblock.reference_block(
        x, weights, biases, DILATIONS, 0.1, torch.bfloat16).float()
    launches = resblock.fused_block.launches
    kernel = resblock.fused_block(
        x, resblock.pack_weights(weights, biases), None, DILATIONS,
        0.1).float()
    torch.cuda.synchronize()
    assert resblock.fused_block.launches == launches + 1
    assert kernel.shape == plain.shape == (batch, frames, channels)
    assert _within_bound(kernel, plain)
    # Each row on its own gives the same row
    if batch > 1:
        row = resblock.fused_block(
            x[3:4], weights, biases, DILATIONS, 0.1).float()
        assert torch.equal(row, kernel[3:4])


def test_resblock_kernel_rejects_what_it_does_not_take(device):
    x, weights, biases = _resblock_problem(device, 1, 40, 32, 3)
    with pytest.raises(TypeError, match='bfloat16'):
        resblock.fused_block(x.float(), weights, biases, DILATIONS, 0.1)
    with pytest.raises(ValueError, match='do not fit'):
        resblock.fused_block(x, weights[:4], biases[:4], DILATIONS, 0.1)
    with pytest.raises(ValueError, match='not cuda'):
        resblock.fused_block(
            x, resblock.pack_weights(weights.cpu(), biases.cpu()), None,
            DILATIONS, 0.1)


###############################################################################
# Zero-shot synthesis and the command-line entry points on the card
###############################################################################


def _zero_shot_inputs(frames, count, seed):
    """`count` feature sets of `frames` frames and unit x-vectors, numpy"""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(count):
        logits = 2 * rng.standard_normal((40, frames))
        sets.append((
            rng.uniform(-80, 10, (513, frames)).astype(np.float32),
            (160 + 40 * np.sin(np.arange(frames) / 7.))[None].astype(
                np.float32),
            rng.uniform(0, 1, (1, frames)).astype(np.float32),
            (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)))
    vectors = rng.standard_normal((count, 512))
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    return sets, list(vectors.astype(np.float32))


@pytest.mark.parametrize('frames', [896, 1280])
def test_resblock_kernel_serves_zero_shot_batches(device, frames):
    """Eight x-vector speakers in one call at full width (bf16): twelve
    Block calls at B = 8, each row within K1's bound of its single call"""
    from pathlib import Path

    import promonet_tpu_torch as port
    config = port.config.load(
        Path(__file__).resolve().parent.parent / 'configs' /
        'promonet-zeroshot.py')
    generator = port.models.init.seeded(
        port.models.Generator(config), 6).to(device).eval()
    sets, xvectors = _zero_shot_inputs(frames, 8, frames)
    launches = resblock.fused_block.launches
    batched = port.synthesize.from_features_batched(
        sets, generator, speakers=xvectors, device=device)
    torch.cuda.synchronize()
    assert resblock.fused_block.launches == launches + 12
    assert tuple(batched.shape) == (8, 1, frames * 256)
    for row, values, vector in zip(batched, sets, xvectors):
        single = torch.from_numpy(port.synthesize.from_features(
            *values, generator=generator, speaker=vector,
            device=device)).to(device)
        assert _within_bound(row, single)


def test_clis_on_the_card_write_what_the_calls_write(device, tmp_path,
                                                     monkeypatch):
    """preprocess → edit → synthesize as `python -m` processes on the
    default CUDA device, against `from_files_to_files` in this process:
    decoded pitch, periodicity and harmonics equal, the rest within 1e-5
    of its scale, the audio within K1's bound. Both sides run PyTorch's
    default TF32 settings (cuDNN on, cuBLAS off), as a CLI process does."""
    import subprocess
    import sys
    from pathlib import Path

    import promonet_tpu_torch as port

    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    root = Path(__file__).resolve().parent.parent
    checkpoint = port.utils.checkpoint
    weights = tmp_path / 'weights'
    for name, model, seed in (
        ('pitch', port.preprocess.PitchCNN(), 1),
        ('ppg', port.preprocess.PPGEncoder(), 2),
    ):
        checkpoint.save(weights / f'{name}-00000001.pt',
                        port.models.init.seeded(model, seed).state_dict())
    config_file = tmp_path / 'cli.py'
    config_file.write_text(
        f"MODULE = 'promonet_tpu_torch'\nCHECKPOINTS_DIR = {str(weights)!r}\n")
    config = port.config.load(config_file)
    generator_file = weights / 'generator-00000001.pt'
    checkpoint.save(generator_file, port.models.init.seeded(
        port.models.Generator(config), 3).state_dict())
    t = np.arange(22050) / 22050
    phase = 2 * np.pi * np.cumsum(180. + 60. * np.sin(2 * np.pi * t)) / 22050
    wav = tmp_path / 'speech.wav'
    port.utils.audio.save(wav, 0.4 * np.sin(phase)[None], 22050)
    cli, ours = tmp_path / 'cli', tmp_path / 'ours'
    cli.mkdir()
    ours.mkdir()

    def files(folder, prefix):
        return [folder / f'{prefix}-{name}.npy' for name in (
            'loudness', 'viterbi-pitch', 'viterbi-periodicity', 'ppg')]

    def run(stage, *arguments):
        result = subprocess.run(
            [sys.executable, '-m', f'promonet_tpu_torch.{stage}',
             *map(str, arguments), '--config', str(config_file)],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert result.returncode == 0, result.stderr

    def flags(folder, prefix):
        return [value for name, file in zip(
            ('loudness', 'pitch', 'periodicity', 'ppg'),
            files(folder, prefix)) for value in (f'--{name}_files', file)]

    features = ('loudness', 'pitch', 'periodicity', 'ppg', 'harmonics')
    run('preprocess', '--files', wav, '--output_prefixes', cli / 'speech',
        '--features', *features)
    run('edit', *flags(cli, 'speech'), '--output_prefixes', cli / 'edited',
        '--pitch_shift_cents', 400., '--time_stretch_ratio', 0.7,
        '--loudness_scale_db', 3.)
    run('synthesize', *flags(cli, 'edited'), '--output_files',
        cli / 'edited.wav', '--speakers', 3, '--checkpoint', generator_file)

    port.preprocess.from_files_to_files(
        [wav], port.load.pitch_model(config=config, device=device),
        port.load.ppg_model(config=config, device=device),
        [ours / 'speech'], features, config=config, device=device)
    port.edit.from_files_to_files(
        *([file] for file in files(cli, 'speech')), [ours / 'edited'],
        pitch_shift_cents=400., time_stretch_ratio=0.7, loudness_scale_db=3.,
        config=config, device=device)
    port.synthesize.from_files_to_files(
        *([file] for file in files(cli, 'edited')), [ours / 'edited.wav'],
        port.load.generator(generator_file, config, device), speakers=[3],
        device=device)
    names = sorted(path.name for path in cli.iterdir())
    assert names == sorted(path.name for path in ours.iterdir())
    for name in names:
        if not name.endswith('.npy'):
            continue
        a, b = np.load(cli / name), np.load(ours / name)
        if name.startswith('speech') and any(
                part in name for part in ('pitch', 'periodicity', 'harmonics')):
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1e-5 * max(1., np.abs(b).max())
    audio = [torch.from_numpy(port.utils.audio.load(folder / 'edited.wav')[0])
             for folder in (cli, ours)]
    assert audio[0].shape == (1, round(86 / 0.7) * 256)
    assert _within_bound(*audio)


def test_resblock_kernel_serves_the_mel_generator(device):
    """MelGenerator at full width (configs/baselines/mels.py, bf16) runs
    its 12 Blocks through K1; its audio against the plain CPU path in
    float32 within 5% relative RMS, as the smoke holds Generator"""
    from pathlib import Path

    import promonet_tpu_torch as port
    config = port.config.load(
        Path(__file__).resolve().parent.parent / 'configs' / 'baselines' /
        'mels.py')
    generator = port.models.init.seeded(
        port.models.MelGenerator(config), 8).to(device).eval()
    reference = port.models.MelGenerator(config.replace(PRECISION='float32'))
    reference.load_state_dict(
        {name: value.cpu() for name, value in generator.state_dict().items()})
    spectrogram = port.preprocess.spectrogram.from_audio(
        torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 100 * 256)).astype(np.float32) * 0.1), config)
    launches = resblock.fused_block.launches
    audio = port.baseline.mels.from_features(
        spectrogram, generator, speaker=3, device=device)
    assert resblock.fused_block.launches == launches + 12
    plain = port.baseline.mels.from_features(
        spectrogram, reference, speaker=3, device='cpu')
    assert audio.shape == plain.shape == (1, 100 * 256)
    assert np.sqrt(np.mean((audio - plain) ** 2) / np.mean(plain ** 2)) < 0.05


def test_evaluation_decodes_once_per_job_on_the_card(device, tmp_path):
    """The corpus takes one K2 decode per wav; the evaluation's
    re-preprocess one per job, and every generator call 12 K1 calls"""
    import contextlib

    import promonet_tpu_torch as port
    config = port.config.load().replace(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        EVAL_DIR=tmp_path / 'eval', RESULTS_DIR=tmp_path / 'results',
        CHECKPOINTS_DIR=tmp_path / 'checkpoints', RUNS_DIR=tmp_path / 'runs',
        EVALUATION_RATIOS=[1.414])
    decodes = viterbi.decode.launches
    port.data.synthetic.create(
        speakers=2, utterances=3, seconds=0.5, config=config, device=device)
    assert viterbi.decode.launches == decodes + 6

    phases, phase = {}, port.utils.timer.Timer.phase

    @contextlib.contextmanager
    def counted(self, name):
        before = (viterbi.decode.launches, resblock.fused_block.launches)
        with phase(self, name):
            yield
        counts = phases.setdefault(name, [0, 0])
        counts[0] += viterbi.decode.launches - before[0]
        counts[1] += resblock.fused_block.launches - before[1]

    port.utils.timer.Timer.phase = counted
    try:
        results = port.evaluate.datasets(
            ['synthetic'], config=config, device=device)
    finally:
        port.utils.timer.Timer.phase = phase
    assert len(results['synthetic']['objective']) == 6
    # 2 test stems x 6 conditions
    assert phases['preprocess'] == [12, 0]
    assert phases['generate'][0] == 0 and phases['generate'][1] % 12 == 0
    assert phases['generate'][1] > 0


###############################################################################
# Training (K1 serves validation only)
###############################################################################


def _train_batch(config, seed, batch=2, frames=8):
    rng = np.random.default_rng(seed)
    ppg = rng.random((batch, config.PPG_CHANNELS, frames)).astype(np.float32)
    return {
        'loudness': rng.uniform(-80, 0, (batch, 513, frames)).astype(
            np.float32),
        'pitch': rng.uniform(80, 300, (batch, frames)).astype(np.float32),
        'periodicity': rng.random((batch, frames)).astype(np.float32),
        'ppg': ppg / ppg.sum(1, keepdims=True),
        'speakers': np.arange(batch, dtype=np.int32),
        'spectral_balance_ratios': np.ones(batch, np.float32),
        'loudness_ratios': np.ones(batch, np.float32),
        'spectrograms': np.abs(rng.standard_normal(
            (batch, 513, frames))).astype(np.float32) + 1e-3,
        'audio': (0.3 * rng.standard_normal(
            (batch, 1, frames * config.HOPSIZE))).astype(np.float32)}


def test_training_route_launches_no_block_kernel(device):
    """HiFi-GAN 512 in bf16 on the card: train=True back-propagates
    through cuDNN convolutions (under REMAT) with no K1 launch; the
    inference route launches it 12 times"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core
    config = port.config.load()
    generator = port.models.init.seeded(
        port.models.Generator(config), 0).to(device)
    batch = core.to_device(_train_batch(config, 0, frames=64), device)
    launches = resblock.fused_block.launches
    audio = generator(*core.generator_args(batch, config), train=True)
    audio.float().pow(2).mean().backward()
    assert resblock.fused_block.launches == launches
    weight = generator.backbone.stages[3].blocks[2].weight
    assert weight.grad is not None and torch.isfinite(weight.grad).all()
    with torch.inference_mode():
        generator(*core.generator_args(batch, config))
    assert resblock.fused_block.launches == launches + 12


def test_narrow_float32_step_on_the_card_matches_the_cpu(device):
    """One float32 training step from the same seeded state on the card and
    on the CPU (TF32 off): every loss within 1e-4 relative"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
        PRECISION='float32')
    batch = _train_batch(config, 1)
    losses = []
    for where in ('cpu', device):
        state = core.create_state(config, where)
        metrics = core.train_step(state, core.to_device(batch, where))
        losses.append({name: float(value) for name, value in metrics.items()
                       if name.startswith('loss/')})
    for name, value in losses[0].items():
        assert abs(losses[1][name] - value) <= 1e-4 * abs(value), name


@pytest.mark.parametrize('frames', [64, 128])
def test_resblock_kernel_serves_validation_shapes(device, frames):
    """Validation synthesizes one item at a time, padded to its bucket:
    K1 at (1, bucket x upsampling) of each stage, within the bound"""
    rates, channels = (8, 8, 2, 2), 512
    length = frames
    for rate in rates:
        channels, length = channels // 2, length * rate
        for kernel_size in (3, 7, 11):
            x, weights, biases = _resblock_problem(
                device, 1, length, channels, kernel_size)
            launches = resblock.fused_block.launches
            kernel = resblock.fused_block(
                x, weights, biases, DILATIONS, 0.1).float()
            assert resblock.fused_block.launches == launches + 1
            plain = resblock.reference_block(
                x, weights, biases, DILATIONS, 0.1, torch.bfloat16).float()
            assert _within_bound(kernel, plain), (length, channels)


###############################################################################
# This slice's call sites: the registered operator, the exported program,
# CARGAN and FARGAN's training route on the card
###############################################################################


def test_resblock_operator_is_the_kernel(device):
    """`torch.ops.promonet_tpu_torch.resblock` over packed tiles launches
    the kernel once and gives `fused_block`'s result"""
    x, weights, biases = _resblock_problem(device, 2, 300, 128, 7)
    packed = resblock.pack_weights(weights, biases)
    launches = resblock.fused_block.launches
    through_op = torch.ops.promonet_tpu_torch.resblock(
        x, packed.tensor, packed.biases, 128, list(DILATIONS), 0.1, 0)
    assert resblock.fused_block.launches == launches + 1
    assert torch.equal(
        through_op, resblock.fused_block(x, packed, None, DILATIONS, 0.1))


def test_exported_program_launches_the_kernel(device, tmp_path):
    """A full-width bf16 generator exported on the card: the loaded
    program's twelve Blocks are K1 calls, within the bf16 bound of eager
    `packed_inference`"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.models import export
    config = port.config.load()
    generator = port.models.init.seeded(port.models.Generator(config), 0)
    checkpoint = tmp_path / 'generator-00000001.pt'
    port.utils.checkpoint.save(checkpoint, generator.state_dict(), step=1)
    export.from_file_to_file(
        checkpoint, tmp_path / 'exported', config=config, device=device)
    program = torch.export.load(tmp_path / 'exported.pt2').module()
    sets, _ = _zero_shot_inputs(32, 1, 5)
    loudness, pitch, periodicity, ppg = (
        torch.from_numpy(value)[None].to(device) for value in sets[0])
    x = export.pack_features(
        loudness, pitch[0], periodicity[0], ppg,
        torch.tensor([3], device=device), torch.ones(1, device=device),
        torch.ones(1, device=device), config)
    eager_generator = port.load.generator(checkpoint, config, device)
    launches = resblock.fused_block.launches
    with torch.inference_mode():
        audio = program(x)
    assert resblock.fused_block.launches == launches + 12
    with torch.inference_mode():
        eager = export.packed_inference(eager_generator, x)
    assert audio.shape == (1, 1, 8192)
    assert _within_bound(audio.float(), eager.float())


def test_cargan_blocks_are_the_kernel(device):
    """CARGAN at full width in bf16: 12 K1 calls, finite audio"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.models import cargan
    config = port.config.load()
    model = port.models.init.seeded(
        cargan.CARGAN(100, 130, config), 0).to(device).eval()
    rng = np.random.default_rng(6)
    features = torch.from_numpy(rng.standard_normal(
        (1, 64, 100)).astype(np.float32)).to(device)
    global_features = torch.from_numpy(rng.standard_normal(
        (1, 1, 130)).astype(np.float32)).to(device)
    launches = resblock.fused_block.launches
    with torch.inference_mode():
        audio = model(features, global_features, dtype=torch.bfloat16)
    assert resblock.fused_block.launches == launches + 12
    assert audio.shape == (1, 64 * 256, 1)
    assert torch.isfinite(audio).all()


def test_fargan_step_on_the_card_matches_the_cpu(device):
    """One narrow float32 FARGAN step (configs/fargan.py) on the card and
    on the CPU, the same noise drawn for both: no K1 launch, every loss
    within 1e-4 relative"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core
    config = port.config.load(
        Path(__file__).resolve().parent.parent / 'configs' / 'fargan.py'
    ).replace(
        BATCH_SIZE=2, CHUNK_SIZE=1536, PRECISION='float32')
    batch = _train_batch(config, 2, frames=6)
    losses = []
    for where in ('cpu', device):
        generator = torch.Generator().manual_seed(7)
        state = core.create_state(config, where)
        launches = resblock.fused_block.launches
        metrics = core.train_step(
            state, core.to_device(batch, where),
            noise=lambda x, generator=generator: torch.rand(
                x.shape, generator=generator, dtype=x.dtype).to(x.device))
        assert resblock.fused_block.launches == launches
        losses.append({name: float(value) for name, value in metrics.items()
                       if name.startswith('loss/')})
    for name, value in losses[0].items():
        assert abs(losses[1][name] - value) <= 1e-4 * abs(value), name


@pytest.mark.parametrize('frames', [1, 120, 896])
@pytest.mark.parametrize('transition', ['uniform', 'pitch'])
def test_from_probabilities_reaches_the_viterbi_kernel(
        device, frames, transition):
    """The default uniform transition, where every predecessor ties, and
    the pitch decode's: one launch, the plain path"""
    rng = np.random.default_rng(frames)
    probabilities = torch.softmax(torch.from_numpy(
        3 * rng.standard_normal((frames, 256))).float(), -1)
    matrix = None if transition == 'uniform' else torch.exp(
        viterbi.triangular_transition(256, 9.))
    plain = viterbi.from_probabilities(probabilities, matrix)
    launches = viterbi.decode.launches
    kernel = viterbi.from_probabilities(
        probabilities.to(device),
        None if matrix is None else matrix.to(device))
    assert viterbi.decode.launches == launches + 1
    np.testing.assert_array_equal(kernel.cpu().numpy(), plain.numpy())


def _extractor_problem(name, rng):
    """A seeded extractor on the CPU, its loss, its optimizer and a
    numpy-seeded float32 batch at the JAX package's batch size"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.preprocess import pitch, ppg, speaker, training
    seeded = port.models.init.seeded
    if name == 'pitch':
        model, rate = seeded(pitch.PitchCNN(), 0), 2e-4
        batch = (rng.standard_normal((128, 1024)).astype(np.float32),
                 rng.integers(0, 256, 128))
    elif name == 'ppg':
        model, rate = seeded(ppg.PPGEncoder(), 0), 1e-3
        batch = (rng.standard_normal((32, 256, 80)).astype(np.float32),
                 rng.integers(0, 40, (32, 256)),
                 (rng.random((32, 256)) < .8).astype(np.float32))
    else:
        model, rate = seeded(speaker.Classifier(16), 0), 3e-4
        batch = (rng.standard_normal((32, 256, 80)).astype(np.float32),
                 rng.integers(0, 16, 32), rng.integers(64, 257, 32))
    if name == 'speaker':
        def optimizer(model):
            return torch.optim.Adam(model.parameters(), lr=rate), None
    else:
        def optimizer(model):
            return training.adamw_cosine(model.parameters(), rate, 100)
    loss = getattr(port.preprocess, name).training_loss
    return model, loss, optimizer, batch, rate


@pytest.mark.parametrize('name', ['pitch', 'ppg', 'speaker'])
def test_extractor_step_on_the_card_matches_the_cpu(device, name):
    """One float32 step from the same weights on the same batch: the loss
    within 1e-4 relative; every weight within 2 lr + 1e-4 of its leaf's
    largest magnitude (an element whose gradient is within rounding of
    zero may step the other way under Adam), and 99% within 1e-4 of it"""
    import copy
    from promonet_tpu_torch.preprocess import training
    model, loss, optimizer, batch, rate = _extractor_problem(
        name, np.random.default_rng(3))
    losses, weights = [], []
    for where in ('cpu', device):
        stepped = copy.deepcopy(model).to(where)
        launches = viterbi.decode.launches
        losses.append(float(training.update(
            loss(stepped, *(torch.from_numpy(value).to(where)
                            for value in batch)), *optimizer(stepped))))
        assert viterbi.decode.launches == launches
        weights.append({key: value.cpu()
                        for key, value in stepped.state_dict().items()})
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    close = []
    for key, value in weights[0].items():
        scale = float(value.abs().max())
        error = (weights[1][key] - value).abs()
        assert float(error.max()) <= 2 * rate + 1e-4 * scale, key
        close.append((error <= 1e-4 * scale).flatten())
    assert float(torch.cat(close).float().mean()) >= .99


###############################################################################
# Resident data, the pause, one rank under NCCL
###############################################################################


def _packed(config, stems=6, seed=0):
    """A packed corpus (`data.resident.pack`'s arrays) of random values"""
    rng = np.random.default_rng(seed)
    frames = 3 * config.CHUNK_SIZE // config.HOPSIZE
    lengths = rng.integers(
        config.CHUNK_SIZE // config.HOPSIZE, frames + 1, stems).astype(
            np.int32)
    return {
        'audio': rng.integers(
            -2 ** 15, 2 ** 15, (stems, frames * config.HOPSIZE)).astype(
                np.int16),
        'loudness': rng.uniform(-80, 0, (stems, 8, frames)).astype(
            np.float16),
        'pitch': rng.uniform(80, 300, (stems, frames)).astype(np.float16),
        'periodicity': rng.random((stems, frames)).astype(np.float16),
        'ppg': rng.random((stems, config.PPG_CHANNELS, frames)).astype(
            np.float16),
        'lengths': lengths,
        'speakers': np.arange(stems, dtype=np.int32),
        'spectral_balance_ratios': np.ones(stems, np.float32),
        'loudness_ratios': np.ones(stems, np.float32)}


def test_resident_crops_and_sample_on_the_card_match_the_cpu(device):
    """The gather on the card equals the CPU's for the same rows and
    starts; the draws on the card lie within their stems"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.data import resident
    config = port.config.load()
    packed = _packed(config)
    data = resident.to_device(packed, device)
    cpu = resident.to_device(packed, 'cpu')
    frames = config.CHUNK_SIZE // config.HOPSIZE
    generator = torch.Generator(device=device).manual_seed(0)
    rows, starts = resident.draw(data, generator, 4096, frames)
    assert rows.device.type == 'cuda'
    assert bool(((starts >= 0) &
                 (starts <= data['lengths'][rows] - frames)).all())
    card = resident.crops(data, rows[:64], starts[:64], frames)
    plain = resident.crops(cpu, rows[:64].cpu(), starts[:64].cpu(), frames)
    for name, value in plain.items():
        assert torch.equal(card[name].cpu(), value), name
    batch = resident.sample(data, generator, 8, config)
    assert batch['audio'].shape == (8, 1, config.CHUNK_SIZE)
    assert batch['audio'].device.type == 'cuda'


def test_resident_step_launches_no_block_kernel(device):
    """A narrow training step on a resident batch drawn on the card: no
    K1 launch, finite losses"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.data import resident
    from promonet_tpu_torch.train import core
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2)
    data = resident.to_device(_packed(config), device)
    batch = resident.sample(
        data, torch.Generator(device=device).manual_seed(1), 2, config)
    batch['spectrograms'] = port.preprocess.spectrogram.from_audio(
        batch['audio'], config)
    state = core.create_state(config, device)
    launches = resblock.fused_block.launches
    metrics = core.train_step(state, batch)
    assert resblock.fused_block.launches == launches
    assert all(bool(torch.isfinite(value)) for value in metrics.values())


def test_maybe_pause_synchronizes_the_card(device, tmp_path):
    """The trainer's drain, `pause.synchronize`, leaves the card idle
    before the checkpoint and the acknowledgement"""
    import os
    import threading
    import time

    import promonet_tpu_torch as port
    from promonet_tpu_torch.utils import pause
    config = port.config.load().replace(RUNS_DIR=tmp_path / 'runs')
    pause.register_trainer(config)
    try:
        x = torch.randn(4096, 4096, device=device)
        for _ in range(50):
            x = x @ x
            x = x / x.norm()
        idle = []
        pause.pause_file(config).write_text(str(os.getpid()))
        thread = threading.Thread(target=pause.maybe_pause, kwargs=dict(
            drain=pause.synchronize(device),
            on_pause=lambda: idle.append(torch.cuda.current_stream(
                device).query()),
            poll_seconds=0.02, config=config))
        thread.start()
        deadline = time.time() + 60
        while not pause.ack_file(config).exists() and time.time() < deadline:
            time.sleep(0.01)
        assert idle == [True]
        pause.pause_file(config).unlink()
        thread.join(60)
        assert not thread.is_alive()
    finally:
        pause.unregister_trainer(config)


def test_one_nccl_rank_steps_as_the_card_alone(device, tmp_path):
    """A process group of one rank under NCCL: each step issues the two
    gradient all-reduces, and its losses are those of the step without
    the group (float32, within 1e-5 relative)"""
    import torch.distributed as dist

    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core
    config = port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
        PRECISION='float32')
    batch = core.to_device(_train_batch(config, 2), device)
    alone = core.create_state(config, device)
    expected = core.train_step(alone, batch)
    dist.init_process_group(
        'nccl', init_method=f'file://{tmp_path / "store"}', rank=0,
        world_size=1)
    try:
        state = core.create_state(config, device)
        state.mesh = port.parallel.create_mesh(config=config, device=device)
        launches = port.parallel.all_reduce_mean.launches
        metrics = core.train_step(state, batch)
        assert port.parallel.all_reduce_mean.launches == launches + 2
    finally:
        dist.destroy_process_group()
    for name, value in expected.items():
        assert abs(float(metrics[name]) - float(value)) <= \
            1e-5 * abs(float(value)), name


###############################################################################
# The training step as CUDA graphs (`train.graphs`)
###############################################################################

# A bf16 step: relative gaps within one bf16 rounding step
BF16_GAP = 2 ** -7


@pytest.fixture
def deterministic(device):
    """cuDNN's deterministic algorithms, so that a graphed step and an
    eager step do the same arithmetic: a nondeterministic weight
    gradient's atomics move a narrow bf16 step's largest gradient by a
    third between two eager runs"""
    torch.backends.cudnn.deterministic = True
    yield device
    torch.backends.cudnn.deterministic = False


def _graph_batches(config, count, device, seed):
    """`count` training batches of BATCH_SIZE x CHUNK_SIZE made on the
    card"""
    import promonet_tpu_torch as port
    generator = torch.Generator(device=device).manual_seed(seed)
    rows, frames = config.BATCH_SIZE, config.CHUNK_SIZE // config.HOPSIZE

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    out = []
    for _ in range(count):
        audio = 0.1 * torch.randn(
            (rows, 1, config.CHUNK_SIZE), generator=generator, device=device)
        ppg = uniform(rows, config.PPG_CHANNELS, frames)
        out.append({
            'loudness': -80. + 80. * uniform(
                rows, config.WINDOW_SIZE // 2 + 1, frames),
            'pitch': 80. + 220. * uniform(rows, frames),
            'periodicity': uniform(rows, frames),
            'ppg': ppg / ppg.sum(1, keepdim=True),
            'speakers': torch.randint(
                0, config.NUM_SPEAKERS, (rows,), generator=generator,
                device=device),
            'spectral_balance_ratios': 0.9 + 0.2 * uniform(rows),
            'loudness_ratios': 0.9 + 0.2 * uniform(rows),
            'spectrograms': port.preprocess.spectrogram.from_audio(
                audio, config),
            'audio': audio})
    return out


def _twins(config, device, monkeypatch=None):
    """Two `State`s from one seed, each keeping the generator's output of
    every step by a forward hook: the first eager (a forward pre-hook is
    one of the cases a graph cannot serve), the second free to be
    graphed. With `monkeypatch`, the eager twin's Adam and AdamW stay
    capturable, as a graphed key's are, so that the twins do the same
    optimizer arithmetic: an eager-only state's plain AdamW rounds its
    float32 update otherwise, which moves a narrow bf16 step's gradient
    extrema by more than a bf16 step"""
    from promonet_tpu_torch.train import core, graphs
    states, outputs = [], []
    if monkeypatch is not None:
        switch = graphs.capturable
        monkeypatch.setattr(graphs, 'capturable', lambda state, on: switch(
            state, on or state is states[0]))
    for eager in (True, False):
        state = core.create_state(config, device)
        kept = []
        if eager:
            state.generator.register_forward_pre_hook(lambda *_: None)
        state.generator.register_forward_hook(
            lambda module, args, output, kept=kept: kept.append(
                output.detach().clone()))
        states.append(state)
        outputs.append(kept)
    return states, outputs


def _assert_metrics_close(metrics, expected, index, gap=BF16_GAP):
    assert list(metrics) == list(expected)
    for name, value in expected.items():
        assert abs(float(metrics[name]) - float(value)) <= \
            gap * abs(float(value)) + 1e-6, (index, name)


def _gap(ours, theirs):
    return float((ours.float() - theirs.float()).norm() /
                 theirs.float().norm().clamp_min(1e-30))


def _assert_states_close(graphed, eager):
    """Every leaf's change and AdamW moment, all leaves together, within
    a bf16 step of the eager state's"""
    pairs = []
    for state in (graphed, eager):
        leaves = [state.trainable[name] for name in state.names] + list(
            state.discriminator.parameters())
        moments = {kind: torch.cat([
            optimizer.state[leaf][kind].reshape(-1) for optimizer, group in (
                (state.generator_optimizer, leaves[:len(state.names)]),
                (state.discriminator_optimizer, leaves[len(state.names):]))
            for leaf in group]) for kind in ('exp_avg', 'exp_avg_sq')}
        pairs.append((torch.cat([leaf.detach().reshape(-1)
                                 for leaf in leaves]), moments))
    (leaves, moments), (eager_leaves, eager_moments) = pairs
    for kind in moments:
        assert _gap(moments[kind], eager_moments[kind]) <= BF16_GAP, kind
    return leaves, eager_leaves


def test_graphed_steps_match_eager_steps(deterministic, monkeypatch):
    """Five steps on resident 64 x 16384 batches at full width, eagerly
    and graphed (an eager step, the capture, three replays): the losses,
    the leaves' changes and AdamW's moments agree within bf16 limits; the
    generator's forward hook fires once a step with the replayed output;
    the metrics a step returned are unchanged by the next"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core, graphs
    device = deterministic
    config = port.config.load()
    batches = _graph_batches(config, 5, device, 0)
    (eager, graphed), (eager_outputs, outputs) = _twins(
        config, device, monkeypatch)
    start = torch.cat([leaf.detach().reshape(-1).clone() for leaf in (
        [graphed.trainable[name] for name in graphed.names] +
        list(graphed.discriminator.parameters()))])
    replays, returned = graphs.Graphs.replays, []
    for index, batch in enumerate(batches):
        expected = core.train_step(eager, batch)
        metrics = core.train_step(graphed, batch)
        assert graphs.Graphs.replays == replays + index
        assert len(outputs) == index + 1
        returned.append((metrics, {name: value.clone()
                                   for name, value in metrics.items()}))
        _assert_metrics_close(metrics, expected, index)
    assert graphs.Graphs.replays == replays + 4
    assert eager.graphs is None and graphed.graphs.phases is not None
    for ours, theirs in zip(outputs, eager_outputs):
        assert _gap(ours, theirs) <= BF16_GAP
    for metrics, kept in returned:
        for name, value in kept.items():
            assert torch.equal(metrics[name], value), name
    leaves, eager_leaves = _assert_states_close(graphed, eager)
    assert _gap(leaves - start, eager_leaves - start) <= BF16_GAP


def _narrow(**overrides):
    import promonet_tpu_torch as port
    return port.config.load().replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
        **overrides)


def test_a_loaded_checkpoint_is_recaptured(
        deterministic, tmp_path, monkeypatch):
    """`load_checkpoint` into a graphed state drops its graphs: the next
    step runs eagerly, the one after recaptures, and both match the
    steps of an eager state loaded from the same checkpoint"""
    from promonet_tpu_torch.train import core, graphs
    device, config = deterministic, _narrow()
    batches = _graph_batches(config, 5, device, 1)
    (eager, graphed), _ = _twins(config, device, monkeypatch)
    for batch in batches[:3]:
        core.train_step(graphed, batch)
    core.save_checkpoint(tmp_path, graphed, 3, 0)
    path = tmp_path / 'generator-00000003.pt'
    for state in (eager, graphed):
        assert core.load_checkpoint(state, path) == (3, 0)
    assert graphed.graphs is None
    replays = graphs.Graphs.replays
    for index, batch in enumerate(batches[3:]):
        expected = core.train_step(eager, batch)
        metrics = core.train_step(graphed, batch)
        assert graphs.Graphs.replays == replays + index
        _assert_metrics_close(metrics, expected, index)
    _assert_states_close(graphed, eager)


def test_a_changed_switch_runs_eagerly(deterministic, monkeypatch):
    """`adversarial` off for two steps, then on for three: the step that
    turns it on runs eagerly and the next recaptures; every step matches
    the eager state's"""
    from promonet_tpu_torch.train import core, graphs
    device, config = deterministic, _narrow()
    batches = _graph_batches(config, 5, device, 2)
    (eager, graphed), _ = _twins(config, device, monkeypatch)
    replays, graphed_steps = graphs.Graphs.replays, []
    for index, batch in enumerate(batches):
        adversarial = index >= 2
        expected = core.train_step(eager, batch, adversarial=adversarial)
        before = graphs.Graphs.replays
        metrics = core.train_step(graphed, batch, adversarial=adversarial)
        graphed_steps.append(graphs.Graphs.replays - before)
        _assert_metrics_close(metrics, expected, index)
    assert graphed_steps == [0, 1, 0, 1, 1]
    assert graphs.Graphs.replays == replays + 3
    _assert_states_close(graphed, eager)


def test_fargan_replays_draw_the_eager_noise(deterministic, monkeypatch):
    """A narrow bf16 FARGAN step draws its noise from `State.rng`: the
    graphed steps (the generator registered with the first graph) give
    the eager steps' outputs and losses, so a replay draws the numbers an
    eager step would"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core, graphs
    config = port.config.load(
        Path(__file__).resolve().parent.parent / 'configs' / 'fargan.py'
    ).replace(BATCH_SIZE=2, CHUNK_SIZE=1536)
    device = deterministic
    batches = _graph_batches(config, 4, device, 3)
    (eager, graphed), (eager_outputs, outputs) = _twins(
        config, device, monkeypatch)
    replays = graphs.Graphs.replays
    for index, batch in enumerate(batches):
        _assert_metrics_close(core.train_step(graphed, batch),
                              core.train_step(eager, batch), index)
    assert graphs.Graphs.replays == replays + 3
    for ours, theirs in zip(outputs, eager_outputs):
        assert _gap(ours, theirs) <= 1e-3


def test_nccl_steps_stay_eager(deterministic, tmp_path):
    """One NCCL rank with the mesh set: its steps run eagerly (captured
    all-reduces hung on four cards) with plain optimizers, their step
    counts on the host, each issuing its two all-reduces, and three of
    them match the steps of a state without the group (float32, within
    1e-5 relative)"""
    import torch.distributed as dist

    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core, graphs
    device, config = deterministic, _narrow(PRECISION='float32')
    batches = _graph_batches(config, 3, device, 4)
    (alone, state), _ = _twins(config, device)
    expected = [core.train_step(alone, batch) for batch in batches]
    dist.init_process_group(
        'nccl', init_method=f'file://{tmp_path / "store"}', rank=0,
        world_size=1)
    try:
        state.mesh = port.parallel.create_mesh(config=config, device=device)
        replays = graphs.Graphs.replays
        launches = port.parallel.all_reduce_mean.launches
        metrics = [core.train_step(state, batch) for batch in batches]
        torch.cuda.synchronize()
        assert graphs.Graphs.replays == replays
        assert port.parallel.all_reduce_mean.launches == launches + 6
        for optimizer in (state.generator_optimizer,
                          state.discriminator_optimizer):
            assert optimizer.param_groups[0]['capturable'] is False
            assert all(saved['step'].device.type == 'cpu'
                       for saved in optimizer.state.values())
    finally:
        dist.destroy_process_group()
    for index, (ours, theirs) in enumerate(zip(metrics, expected)):
        _assert_metrics_close(ours, theirs, index, 1e-5)


def test_a_rebound_train_step_trains_by_graphs(device, tmp_path, monkeypatch):
    """`train` with `core.train_step` rebound to a wrapper, as the smoke's
    timed steps and the benchmark's controls rebind it: five resident
    steps, the first eager and the four after it replays, every loss
    finite"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.train import core, graphs
    config = _narrow(
        CACHE_DIR=tmp_path / 'cache', PARTITIONS_DIR=tmp_path / 'partitions',
        AUGMENT_DIR=tmp_path / 'augmentations', RUNS_DIR=tmp_path / 'runs',
        CHECKPOINTS_DIR=tmp_path / 'checkpoints', DEFAULT_EVALUATION_STEPS=1)
    port.data.synthetic.create(
        speakers=2, utterances=4, seconds=0.5, preprocess=False,
        config=config, device=device)
    port.data.augment.datasets(['synthetic'], config)
    port.data.preprocess.core.datasets(
        ['synthetic'], config=config, device=device)
    monkeypatch.setattr(
        port.utils.log, '_tensorboard_writer', lambda directory: None)
    step, seen = core.train_step, []

    def wrapper(*args, **kwargs):
        seen.append(graphs.Graphs.replays)
        return step(*args, **kwargs)

    monkeypatch.setattr(core, 'train_step', wrapper)
    replays, losses = graphs.Graphs.replays, []
    port.train(
        tmp_path / 'run', 'synthetic', steps=5, config=config, device=device,
        callback=lambda step, metrics: losses.append(
            float(metrics['loss/generator/total'])))
    assert seen == [replays, replays, replays + 1, replays + 2, replays + 3]
    assert graphs.Graphs.replays == replays + 4
    assert losses and all(np.isfinite(loss) for loss in losses)


###############################################################################
# K4: FARGAN's subframe network as one launch
###############################################################################

# The benchmark's readings of the plain bf16 program against its float32
# reference over 25 seeds (PERF.md, section 2): every subframe's output,
# relative, and the worst carried state, relative
FARGAN_OUTPUT_GAP = 0.006
FARGAN_STATE_GAP = 0.0047


def _fargan_backbone(device, seed=21):
    from promonet_tpu_torch.models import fargan, init
    return init.seeded(fargan.FARGAN(13, 6), seed).to(device).eval()


def _fargan_features(batch, frames, seed, device):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((batch, frames, 13)).astype(np.float32)
    # Pitch periods from two periods back (below 64) to the longest
    features[..., -1] = rng.uniform(20., 450., (batch, frames))
    global_features = rng.standard_normal((batch, 1, 6)).astype(np.float32)
    return (torch.from_numpy(features).to(device),
            torch.from_numpy(global_features).to(device))


def _fargan_calls(backbone, features, global_features):
    """(audio, [(inputs, output, states)] of every subframe call): a
    forward hook keeps each call's tensors, as the benchmark's check does"""
    kept = []
    handle = backbone.subframe.register_forward_hook(
        lambda module, arguments, output: kept.append(
            (arguments[:4], output[0], output[1])))
    try:
        with torch.no_grad():
            audio = backbone(features, global_features, torch.bfloat16)
    finally:
        handle.remove()
    return audio, kept


@pytest.mark.parametrize('batch', [1, 3, 16, 40])
def test_fargan_kernel_matches_the_plain_subframe(device, batch):
    """A whole bf16 synthesis through K4, each subframe held to the plain
    subframe in float32 from the same inputs, as the benchmark holds the
    program: the fed history exact, every output and the carried states
    within the plain program's own readings; one launch a subframe"""
    from promonet_tpu_torch.models import fargan
    from promonet_tpu_torch.ops import fargan as kernel
    backbone = _fargan_backbone(device)
    frames = 24
    features, global_features = _fargan_features(batch, frames, batch, device)
    launches = kernel.subframe.launches
    audio, calls = _fargan_calls(backbone, features, global_features)
    torch.cuda.synchronize()
    count = frames * backbone.subframes
    assert kernel.subframe.launches == launches + count
    assert len(calls) == count
    # The history: what each subframe was fed is what the loop's own
    # samples hold at its pitch periods, exactly
    size, history = backbone.subframe_size, backbone.num_previous
    samples = torch.cat((
        torch.zeros((batch, history), device=device), audio[..., 0]), -1)
    period = torch.clamp(torch.round(features[..., -1]).long(), 1,
                         history - size - 2)
    index = fargan.lookback_index(period, history, size)
    for step, ((_, lookback, previous, _), output, _) in enumerate(calls):
        window = samples[:, step * size:step * size + history]
        fed = torch.gather(window, 1, index[:, step // backbone.subframes])
        assert torch.equal(lookback.float(), fed)
        assert torch.equal(previous.float(), window[:, -size:])
        assert torch.equal(output.float(),
                           samples[:, history + step * size:][:, :size])
    # Every subframe against the plain subframe in float32
    inputs = [torch.cat([call[0][k].float() for call in calls])
              for k in range(3)]
    states = [torch.cat([call[0][3][k].float() for call in calls])
              for k in range(4)]
    outputs = torch.cat([call[1].float() for call in calls])
    carried = [torch.cat([call[2][k].float() for call in calls])
               for k in range(4)]
    with torch.no_grad():
        plain, plain_states = backbone.subframe.plain(
            *inputs, states, torch.float32, None)
    output_gap = float((outputs - plain).norm() / plain.norm())
    state_gap = max(float((state - reference).norm() / reference.norm())
                    for state, reference in zip(carried, plain_states))
    assert output_gap <= FARGAN_OUTPUT_GAP, output_gap
    assert state_gap <= FARGAN_STATE_GAP, state_gap
    # The states a call returns are those the next call receives
    for (_, _, returned), (arguments, _, _) in zip(calls, calls[1:]):
        assert all(a is b for a, b in zip(returned, arguments[3]))


def test_fargan_kernel_runs_are_bit_equal_with_and_without_a_hook(device):
    """Two runs through K4 give the same bits, hooked or not"""
    backbone = _fargan_backbone(device)
    features, global_features = _fargan_features(1, 40, 5, device)
    hooked, _ = _fargan_calls(backbone, features, global_features)
    with torch.no_grad():
        plain_run, carry = backbone(
            features, global_features, torch.bfloat16, return_states=True)
        again, again_carry = backbone(
            features, global_features, torch.bfloat16, return_states=True)
    assert torch.equal(hooked, plain_run) and torch.equal(plain_run, again)
    assert torch.equal(carry[0], again_carry[0])
    for a, b in zip(carry[1], again_carry[1]):
        assert torch.equal(a, b)


def test_fargan_streamer_on_the_kernel_continues_one_call(device):
    """FARGANStreamer over three chunks through K4 against one offline
    call: within the smoke's FARGAN bounds (the conditioning's products
    run over other row counts); the carry itself is the kernel's"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch.ops import fargan as kernel
    config = port.config.load(
        Path(__file__).resolve().parent.parent / 'configs' / 'fargan.py')
    generator = port.models.init.seeded(
        port.models.Generator(config), 4).to(device).eval()
    rng = np.random.default_rng(8)
    frames, chunk = 96, 32
    logits = 2 * rng.standard_normal((config.PPG_CHANNELS, frames))
    features = (
        rng.uniform(-60, 0, (config.LOUDNESS_BANDS, frames)).astype(
            np.float32),
        rng.uniform(80, 300, (1, frames)).astype(np.float32),
        rng.uniform(0, 1, (1, frames)).astype(np.float32),
        (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32))
    offline = port.synthesize.from_features(
        *(torch.from_numpy(x).to(device) for x in features),
        generator=generator, speaker=3, device=device)
    launches = kernel.subframe.launches
    streamer = port.synthesize.FARGANStreamer(
        generator, speaker=3, chunk_frames=chunk, device=device)
    chunked = np.concatenate([
        streamer.feed(*(x[:, start:start + chunk] for x in features))
        for start in range(0, frames, chunk)], -1)
    assert kernel.subframe.launches == launches + frames * 4
    assert chunked.shape == offline.shape == (1, frames * config.HOPSIZE)
    difference = np.abs(chunked - offline)
    assert difference[..., :4 * config.HOPSIZE].max() <= 2. ** -10
    assert difference.max() <= 2. ** -8
    correlation = float((chunked * offline).sum()) / float(
        np.linalg.norm(chunked) * np.linalg.norm(offline))
    assert correlation >= 0.9999


def test_fargan_training_and_float32_take_the_plain_subframe(device):
    """The training route, float32 and autograd launch no K4"""
    from promonet_tpu_torch.ops import fargan as kernel
    backbone = _fargan_backbone(device)
    features, global_features = _fargan_features(2, 3, 9, device)
    launches = kernel.subframe.launches
    with torch.no_grad():
        backbone(features, global_features, torch.float32)
        backbone(features, global_features, torch.bfloat16, train=True)
    # The inference route under autograd (its backward is the training
    # route's)
    backbone(features, global_features, torch.bfloat16)
    assert kernel.subframe.launches == launches
