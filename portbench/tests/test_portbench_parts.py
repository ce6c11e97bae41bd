"""The benchmark's parts on the CPU: traffic laws, counts, the reference
against the port, the import rules, the trace reduction"""
import ast
import json
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from portbench import counts, generate, harness, trace, weights
from portbench.drivers import edit as edit_driver
from portbench.drivers.common import capture
from portbench.reference import chain, models as reference_models
from portbench.reference.precision import EXACT, exact

BENCH = tiny.ROOT / 'portbench'


def test_strata_follow_their_law():
    law = {'law': 'lognormal', 'median': 4.5, 'sigma': 0.6, 'low': 1.,
           'high': 15.}
    values = generate.strata(law, 64)
    assert values.min() >= 1. and values.max() <= 15.
    assert abs(statistics.median(values) - 4.5) < 0.1
    stretch = generate.strata(
        {'law': 'loguniform', 'low': 0.717, 'high': 1.414}, 64)
    assert np.allclose(np.diff(np.log(stretch)), np.log(1.414 / .717) / 64)
    speakers = generate.strata({'law': 'integers', 'count': 109}, 109)
    assert sorted(speakers) == list(range(109))


def test_draw_is_a_shuffle_per_seed():
    laws = json.loads((BENCH / 'traffic' / 'edit.single.json').read_text())[
        'laws']
    laws['speaker']['count'] = 109
    first = generate.draw(laws, 64, 2 ** 31 + 11)
    assert all(np.array_equal(first[name], value) for name, value in
               generate.draw(laws, 64, 2 ** 31 + 11).items())
    other = generate.draw(laws, 64, 12)
    for name in laws:
        assert sorted(first[name]) == sorted(other[name])
    # The work's laws keep their order; the edits' follow the seed
    assert laws['seconds']['order'] == 'fixed'
    assert np.array_equal(first['seconds'], other['seconds'])
    assert not np.array_equal(first['pitch_shift_cents'],
                              other['pitch_shift_cents'])


def test_k1_bound_is_the_smokes():
    """K1's least time is `chip_smoke.py::block_bound_ms` summed over the
    twelve Blocks"""
    import chip_smoke
    import promonet_tpu_torch as port
    config = port.config.load()
    peak = counts.peaks('NVIDIA H100 80GB HBM3')
    frames = 896
    smoke = sum(
        chip_smoke.block_bound_ms(1, samples, channels, kernel)[0]
        for samples, channels in chip_smoke.stage_shapes(config, frames)
        for kernel in config.HIFIGAN_RESBLOCK_KERNEL_SIZES)
    assert counts.k1_least_seconds([frames], config, peak) * 1e3 == \
        pytest.approx(smoke, rel=1e-12)


def test_hifigan_flops_per_output_second():
    import promonet_tpu_torch as port
    config = port.config.load()
    frames_per_second = config.SAMPLE_RATE / config.HOPSIZE
    assert counts.hifigan_flops(frames_per_second, config) / 1e9 == \
        pytest.approx(52.9, abs=0.1)


def test_mfu_infer_counts_by_the_configuration_file(tmp_path):
    """The vocoder's count is the one the configuration's file names; a
    file that names none, or an unknown one, leaves the metric out. The
    preprocess convolutions count at the TF32 peak, its matrix products
    at the float32 peak"""
    import promonet_tpu_torch as port
    config = port.config.load()
    peak = counts.peaks('NVIDIA H100 80GB HBM3')
    pitch, ppg = counts.pitch_cnn_flops(100), counts.ppg_flops(100)
    assert counts.preprocess_least_seconds(100, peak) == pytest.approx(
        (pitch[0] + ppg[0]) / 494.7e12 + (pitch[1] + ppg[1]) / 67e12)
    cell = harness.Cell(harness.load_benchmark(tiny.ROOT),
                        'promonet.edit.single', tiny.ROOT)
    read = cell.reader({'name': 'mfu.infer'})
    window = harness.Window(1, 0, 1., {}, {
        'preprocess_frames': [100], 'generator_calls': [[120]]})

    def reading(config_file):
        return harness.Reading(
            trace.Trace([], {}, (0, 2e9)), {}, window, config, peak,
            config_file)

    least = counts.preprocess_least_seconds(100, peak) + \
        counts.hifigan_flops(120, config) / 989e12
    assert read(reading(cell.config_file)) == pytest.approx(
        100 * least / 2.)
    assert read(reading({})) is None
    assert read(reading({'vocoder_flops': 'cargan_flops'})) is None


def test_block_flops_by_hand():
    # 2 * 1 row * 10 samples * 4 * 4 channels * 3 taps * 6 convolutions
    assert counts.block_flops(1, 10, 4, 3) == 2 * 10 * 4 * 4 * 3 * 6
    # bf16 bytes: input and output, 6 kernels of 3 x 4 x 4, 6 biases of 4
    assert counts.block_bytes(1, 10, 4, 3) == 2 * (80 + 288 + 24)


def test_k2_bound_by_hand():
    peak = {'float32': 1e12, 'bytes': 1e12, 'bfloat16': 1e12}
    # 2 * 10 frames * 256 states * 17 predecessors operations against
    # 4 * (2560 + 4352 + 256 + 10) bytes
    assert counts.k2_least_seconds(10, peak) == max(
        2 * 10 * 256 * 17, 4 * (2560 + 256 * 17 + 256 + 10)) / 1e12


def _port_and_reference(config):
    import promonet_tpu_torch as port
    modules = {'pitch': port.preprocess.PitchCNN(),
               'ppg': port.preprocess.PPGEncoder(),
               'generator': port.models.Generator(config)}
    device = torch.device('cpu')
    ours = {}
    for name, module in modules.items():
        state = weights.seeded_state(module, 3, device, 2.)
        weights.load(module, state)
        reference = {'pitch': reference_models.PitchCNN,
                     'ppg': reference_models.PPGEncoder,
                     'generator': lambda: reference_models.Generator(
                         config)}[name]()
        reference.load_state_dict(state)
        ours[name] = (module.eval(), reference.eval())
    return port, ours


@pytest.mark.parametrize('model', ['hifigan', 'fargan'])
def test_reference_is_the_port_in_float32(model):
    """At float32 the reference's edit chain equals the port's plain
    paths to rounding"""
    import promonet_tpu_torch as port
    torch.set_num_threads(4)
    config = port.config.load().replace(
        PRECISION='float32', MODEL=model, HIFIGAN_UPSAMPLE_INITIAL_SIZE=16)
    port, models = _port_and_reference(config)
    rng = np.random.default_rng(4)
    audio = (0.3 * np.sin(np.arange(9000) * 2 * np.pi * 180 / 22050) +
             0.01 * rng.standard_normal(9000)).astype(np.float32)[None]
    with torch.no_grad(), exact():
        features = port.preprocess.from_audio(
            audio, models['pitch'][0], models['ppg'][0], config=config,
            device='cpu')
        ours = chain.preprocess(torch.from_numpy(audio), models['pitch'][1],
                                models['ppg'][1], config, EXACT)
        for name, value in zip(('loudness', 'pitch', 'periodicity', 'ppg'),
                               features):
            assert torch.allclose(value, ours[name], rtol=1e-4, atol=1e-5)
        edited = port.edit.from_features(
            *features, pitch_shift_cents=300., time_stretch_ratio=0.8,
            loudness_scale_db=2., config=config)
        for value, theirs in zip(edited, chain.edit(
                *features, 300., 0.8, 2., config, EXACT)):
            assert torch.allclose(value, theirs, rtol=1e-6, atol=1e-6)
        audio = port.synthesize.from_features(
            *edited, generator=models['generator'][0], speaker=3,
            device='cpu')
        reference = chain.synthesize(
            models['generator'][1], *edited, 3, config)
        assert np.allclose(audio[0], reference.numpy(), atol=1e-5)
        if model == 'fargan':
            program, reference = models['generator']
            rerun, steps = capture(
                program.backbone.subframe,
                lambda: port.synthesize.from_features(
                    *edited, generator=program, speaker=3, device='cpu'))
            assert np.array_equal(rerun, audio)
            conditioning, lookback = chain.fargan_inputs(
                reference, *edited, 3, config)
            assert torch.allclose(steps.inputs[0], conditioning, atol=1e-6)
            loop = edit_driver.frame_loop(
                reference.backbone, steps, lookback,
                torch.from_numpy(audio[0]))
            assert loop['history'] == 0.
            assert loop['states'] < 1e-5 and loop['audio'] < 1e-5, loop


def test_reference_imports_nothing_of_the_program():
    """No module of portbench/reference imports the port, the JAX package
    or JAX, and importing it loads none of them"""
    for path in (BENCH / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split('.')[0] not in (
                    *harness.FORBIDDEN, 'promonet_tpu_torch'), (path, name)
    loaded = subprocess.run(
        [sys.executable, '-c',
         'import sys; sys.path.insert(0, sys.argv[1]); '
         'import portbench.reference.chain, portbench.reference.train; '
         'print(sorted({m.split(".")[0] for m in sys.modules}))',
         str(tiny.ROOT)], capture_output=True, text=True, check=True).stdout
    for name in (*harness.FORBIDDEN, 'promonet_tpu_torch'):
        assert f"'{name}'" not in loaded


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's: only whole
    top-level names count"""
    import promonet_tpu_torch  # noqa: F401
    for name in list(sys.modules):
        if name.split('.')[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'jaxline', sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'promonet_tpu.models', sys)
    monkeypatch.setitem(sys.modules, 'jaxlib.xla_client', sys)
    assert harness.forbidden_modules() == ['jaxlib', 'promonet_tpu']


def test_trace_union_and_ranges():
    kernels = [(10, 20, 5, 'a'), (15, 30, 6, 'b'), (40, 50, 35, 'c'),
               (60, 70, 55, 'Memcpy HtoD')]
    reduced = trace.Trace(kernels, {'k1': [(0, 8)], 'k2': [(30, 36)],
                                    'window': [(0, 100)]}, (0, 100))
    assert reduced.busy_s() == pytest.approx(40e-9)
    assert reduced.launches() == 3
    assert reduced.device_seconds('k1') == pytest.approx(25e-9)
    assert reduced.device_seconds('k2') == pytest.approx(10e-9)
    assert reduced.device_seconds('absent') is None
    gaps = dict(reduced.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(60e-9)


def test_weights_follow_their_law():
    import promonet_tpu_torch as port
    config = port.config.load()
    discriminator = port.models.Discriminator(config)
    state = weights.seeded_state(discriminator, 5, torch.device('cpu'))
    for name, value in state.items():
        if name.endswith('weight_g'):
            v = state[name[:-1] + 'v']
            assert torch.allclose(
                value.flatten(), v.flatten(1).norm(dim=1), rtol=1e-5)
    again = weights.seeded_state(discriminator, 5, torch.device('cpu'))
    assert all(torch.equal(state[name], again[name]) for name in state)
