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
