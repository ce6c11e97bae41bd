"""Tiny cells for the CPU tests: a checkout-like folder of new files

A cell, its configuration (a narrow HiFi-GAN), its mix and its limits
are written into a temporary folder; the harness finds them by name and
runs them through the real drivers with the port's plain paths.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

NAME = 'tiny'


def root(tmp_path, traffic, limits, model='hifigan', settings='',
         overrides=None):
    """Write the cell `tiny.cell` into `tmp_path` and return its
    benchmark dict

    traffic: the name of one of the benchmark's mixes, whose values
        `overrides` replaces; limits: {number: limit}; settings: more
        lines for the configuration file
    """
    base = tmp_path / 'portbench'
    for folder in ('configs', 'traffic', 'limits', 'metrics'):
        (base / folder).mkdir(parents=True, exist_ok=True)
    (tmp_path / f'{NAME}.py').write_text(
        "MODULE = 'promonet_tpu'\n"
        f"MODEL = '{model}'\n"
        'HIFIGAN_UPSAMPLE_INITIAL_SIZE = 16\n' + settings)
    (base / 'configs' / f'{NAME}.json').write_text(json.dumps({
        'config_file': f'{NAME}.py',
        'generator_weight_gain': 2. if model == 'hifigan' else 1.,
        'values': {'MODEL': model, 'HIFIGAN_UPSAMPLE_INITIAL_SIZE': 16}}))
    mix = json.loads(
        (ROOT / 'portbench' / 'traffic' / f'{traffic}.json').read_text())
    for key, value in (overrides or {}).items():
        if isinstance(value, dict):
            mix[key] = {**mix[key], **value}
        else:
            mix[key] = value
    (base / 'traffic' / f'{NAME}.mix.json').write_text(json.dumps(mix))
    (base / 'limits' / f'{NAME}.cell.json').write_text(json.dumps(limits))
    benchmark = json.loads((ROOT / 'BENCHMARK.json').read_text())
    benchmark['configs'] = [{
        'name': NAME, 'source': 'test', 'file': f'portbench/configs/{NAME}.json',
        'reduced': [], 'why': 'test'}]
    benchmark['workloads'] = [{
        'name': f'{NAME}.cell', 'config': NAME, 'traffic': f'{NAME}.mix',
        'chips': 1, 'why': 'test'}]
    measured = {'train': ['train_step_ms']}.get(
        mix['driver'], ['audio_s_per_s', 'request_p95_ms'])
    for metric in benchmark['end_to_end']:
        if 'workloads' in metric:
            metric['workloads'] = [f'{NAME}.cell'] if metric['name'] in \
                measured else []
    return benchmark


def run(benchmark, folder, seed=7, system='program', seconds=0.5):
    """run_cell on the CPU; returns (result, checks)"""
    torch.set_num_threads(4)
    cell = harness.Cell(benchmark, f'{NAME}.cell', folder)
    return harness.run_cell(
        cell, seed, seconds, 0, time.perf_counter(), torch.device('cpu'),
        system)
