"""Find a cell by name, run it, reduce it, judge it, print it

Everything that belongs to one cell is found by name from
`BENCHMARK.json`: the workload gives its configuration and traffic mix;
the configuration's entry gives its file (`configs/<name>.json`, which
names the repository's configuration file and the values it must
resolve to); the mix is `traffic/<name>.json`, whose `driver` names the
module of `drivers/` that serves it; the limits of the comparison are
`limits/<workload>.json`; each per-layer metric is read by
`metrics/<metric>.py`. A new cell, configuration, mix or metric is new
files and entries only.

A driver module has `setup(context)`, `run(context, state, seconds)`
and `check(context, state, window)`, which returns the numbers compared
by name; see `drivers/edit.py`.
"""
import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

# Top-level module names that may not be loaded when the result prints
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'promonet_tpu')


def forbidden_modules():
    """The forbidden top-level names present in sys.modules, compared whole"""
    return sorted({name.split('.')[0] for name in sys.modules} &
                  set(FORBIDDEN))


@dataclass
class Check:
    """One number compared: it passes when finite and at most `limit`"""
    name: str
    value: float
    limit: float

    @property
    def passed(self):
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Window:
    """What a driver's measured window did

    values: the end-to-end metrics it measured, by name
    work: what the counts of the per-layer readers need (true lengths)
    records: what the check needs (the program's outputs)
    """
    attempted: int
    failed: int
    seconds: float
    values: dict
    work: dict = field(default_factory=dict)
    records: list = field(default_factory=list)


class Cell:
    """A workload of `BENCHMARK.json` and the files it names

    root: the checkout; base: the benchmark's folder (its first path)
    """

    def __init__(self, benchmark, name, root):
        root = Path(root)
        workloads = {cell['name']: cell for cell in benchmark['workloads']}
        if name not in workloads:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json')
        self.benchmark, self.name, self.root = benchmark, name, root
        self.spec = workloads[name]
        self.base = root / benchmark['paths'][0]
        configs = {entry['name']: entry for entry in benchmark['configs']}
        self.config_entry = configs[self.spec['config']]
        self.config_file = json.loads(
            (root / self.config_entry['file']).read_text())
        self.traffic = json.loads(
            (self.base / 'traffic' / f"{self.spec['traffic']}.json").read_text())
        self.limits = json.loads(
            (self.base / 'limits' / f'{name}.json').read_text())
        self.driver = importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")
        self.end_to_end = [
            metric for metric in benchmark['end_to_end']
            if name in metric.get('workloads', (name,))]
        self.per_layer = [
            metric for metric in benchmark['per_layer']
            if name in metric.get('workloads', (name,))]

    def reader(self, metric):
        """The `read` function of metrics/<name>.py"""
        path = self.base / 'metrics' / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric['name'].replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def config(self):
        """The port's configuration of this cell: the repository's file
        of the configuration's entry, which must resolve to every value
        the entry's file states"""
        import promonet_tpu_torch as port
        config = port.config.load(self.root / self.config_file['config_file'])
        differ = {
            key: (value, _plain(getattr(config, key, None)))
            for key, value in self.config_file['values'].items()
            if _plain(getattr(config, key, None)) != value}
        if differ:
            raise ValueError(
                f'{self.config_file["config_file"]} no longer resolves to '
                f'the values of {self.config_entry["file"]}: {differ}')
        return config


def _plain(value):
    """A configuration value as JSON would hold it"""
    if isinstance(value, (list, tuple)):
        return [_plain(item) for item in value]
    if isinstance(value, dict):
        return {key: _plain(item) for key, item in value.items()}
    return value


@dataclass
class Context:
    """What a driver is given"""
    cell: Cell
    config: object
    seed: int
    device: object
    tracer: object
    system: str = 'program'


@dataclass
class Reading:
    """What a per-layer reader is given"""
    trace: object
    spans: dict
    window: Window
    config: object
    peak: dict
    config_file: dict        # the configuration's file of the benchmark


def load_benchmark(root):
    return json.loads((Path(root) / 'BENCHMARK.json').read_text())


def parse(argv):
    parser = argparse.ArgumentParser(description='Run one benchmark cell')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def log(message):
    print(f'portbench: {message}', file=sys.stderr, flush=True)


def main(argv, start, root):
    """Run a cell once; returns the exit code"""
    arguments = parse(argv)
    try:
        benchmark = load_benchmark(root)
        cell = Cell(benchmark, arguments.workload, root)
    except (OSError, KeyError, ValueError, ImportError) as error:
        log(f'cannot find cell {arguments.workload}: {error!r}')
        return 2
    import torch
    if not torch.cuda.is_available():
        log('no CUDA device (torch.cuda.is_available() is False); '
            'nothing was run')
        return 3
    if torch.cuda.device_count() < cell.spec['chips']:
        log(f'the cell needs {cell.spec["chips"]} cards, '
            f'{torch.cuda.device_count()} present; nothing was run')
        return 3
    try:
        result, checks = run_cell(
            cell, arguments.seed, arguments.seconds, arguments.trace, start,
            torch.device('cuda'))
    except Exception:
        log('the run failed:\n' + traceback.format_exc())
        return 1
    loaded = forbidden_modules()
    if loaded:
        log(f'forbidden modules loaded: {loaded}; no result')
        return 4
    emit(result, checks)
    return 0


def run_cell(cell, seed, seconds, trace_on, start, device, system='program'):
    """Set up, measure, reduce and judge one run

    Returns (result dict without `checks`, [Check])
    """
    import torch
    from . import trace as trace_module
    config = cell.config()
    log(f'imports and configuration done at '
        f'{time.perf_counter() - start:.3f} s')
    tracer = trace_module.Tracer(trace_on)
    context = Context(cell, config, seed, device, tracer, system)
    driver = cell.driver
    state = driver.setup(context)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    log(f'set-up {setup_s:.3f} s; window of {seconds} s')
    window = driver.run(context, state, seconds)
    memory_peak = 0
    if device.type == 'cuda':
        memory_peak = max(
            torch.cuda.max_memory_allocated(index)
            for index in range(cell.spec['chips']))
    result = {
        'correct': None, 'attempted': window.attempted,
        'failed': window.failed}
    if trace_on:
        reduced = trace_module.reduce(tracer.profile)
        peak = None
        if device.type == 'cuda':
            from . import counts
            peak = counts.peaks(torch.cuda.get_device_name(0))
        reading = Reading(reduced, dict(tracer.spans), window, config, peak,
                          cell.config_file)
        metrics = {}
        for metric in cell.per_layer:
            value = cell.reader(metric)(reading)
            if value is not None:
                metrics[metric['name']] = {
                    'value': value, 'unit': metric['unit']}
        result['metrics'] = metrics
        result['breakdown'] = {
            'device_ops': reduced.top_device_ops(),
            'idle_gaps': reduced.idle_gaps()}
        device_extra = {'busy_s': reduced.busy_s(),
                        'window_s': reduced.window_s}
        tracer.profile = None
    else:
        metrics = {'setup_s': {'value': setup_s, 'unit': 's'}}
        for metric in cell.end_to_end:
            if metric['name'] == 'setup_s':
                continue
            metrics[metric['name']] = {
                'value': window.values[metric['name']],
                'unit': metric['unit']}
        result['metrics'] = metrics
        device_extra = {}
    result['device'] = device_record(device, cell, memory_peak, device_extra)
    numbers = driver.check(context, state, window)
    # The cell's limits name the numbers it compares; one the driver did
    # not give counts as infinite, one without a limit is only shown.
    # Without limits (readings for setting them) every number is shown
    limits = cell.limits if cell.limits is not None else dict.fromkeys(
        numbers, math.inf)
    checks = [Check(name, float(numbers.get(name, math.inf)), float(limit))
              for name, limit in limits.items()]
    for name in sorted(set(numbers) - set(limits)):
        log(f'not compared in this cell: {name} = {numbers[name]!r}')
    result['correct'] = window.failed == 0 and bool(checks) and all(
        check.passed for check in checks)
    return result, checks


def device_record(device, cell, memory_peak, extra):
    import torch
    record = {'platform': 'gpu' if device.type == 'cuda' else device.type,
              'kind': torch.cuda.get_device_name(0)
              if device.type == 'cuda' else 'cpu',
              'count': cell.spec['chips'],
              'memory_peak_bytes': memory_peak}
    record.update(extra)
    if device.type == 'cuda':
        try:
            smi = subprocess.run(
                ['nvidia-smi', '--query-gpu=name,power.limit',
                 '--format=csv,noheader'], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()
            record['nvidia_smi'] = smi[0] if smi else ''
        except (OSError, subprocess.SubprocessError):
            record['nvidia_smi'] = 'not read'
    return record


def emit(result, checks):
    """The checks as the last lines of standard error, then the result
    line, with the checks under the last key, on standard output"""
    for check in checks:
        print(f'check {check.name} = {check.value!r} (limit {check.limit!r})'
              f'{"" if check.passed else "  FAILED"}', file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result['metrics'] = {
        name: dict(metric, value=_finite(metric['value']))
        for name, metric in result['metrics'].items()}
    result['checks'] = {
        check.name: {'value': _finite(check.value), 'limit': check.limit}
        for check in checks}
    print(json.dumps(result, allow_nan=False), flush=True)


def _finite(value):
    """A compared number for JSON: inf (a missing or misshapen answer) as
    the largest float, NaN as null"""
    if math.isnan(value):
        return None
    return max(min(value, sys.float_info.max), -sys.float_info.max)
