"""Data-parallel GAN training: one global batch over `world` cards, one
process a card, the gradients averaged by the trainer's own all-reduce

The harness's process is rank 0 on the first card; `setup` starts one
process a further card (`python -m portbench.drivers.train_dp`), and the
ranks join one NCCL process group (gloo on the CPU) at
tcp://localhost:<a free port>, each process on a card bound to its share
of the host's physical cores (`pin`). Every rank builds the same weights from
the seed and the same global batches as `train` (`train.make_batches` at
the mix's `batch` rows), keeps its own rows of each
(`parallel.shard_batch`) and steps the port's training state through
`train.core.train_step` with the mesh set, so that each model's
gradients go through `parallel.all_reduce_mean` before its optimizer
step, as the trainer's data-parallel path takes them. The ranks move in
lockstep: rank 0 says before each step of the window, over a gloo group
of its own, whether there is one.

End-to-end: `train_step_ms` on rank 0: the window, from a barrier of
all ranks to a barrier after the last step, over the steps taken.

The comparison is `train`'s, with rank 0 held to the reference trained
on the whole global batch on one card: each step's losses averaged over
the ranks (`train.core.average_metrics`), the first step's audio of rank
0's rows, the gradients (the averaged ones) and the changes. Besides,
`ranks_differ`: the values of the parameters (generator and
discriminators) in which any rank differs from rank 0 after the window,
which data parallelism keeps at zero. The control (the reference in
float8 in the program's place) trains on one card.
"""
import argparse
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from .. import harness, trace
from ..reference.precision import EXACT, FLOAT8
from . import common, train

ROOT = Path(__file__).resolve().parents[2]

# Seconds a collective may wait for a rank before the run fails
TIMEOUT = 300


@dataclasses.dataclass
class Group:
    """This process's place in the world"""
    rank: int
    world: int
    mesh: object
    flags: object            # the gloo group of the window's flags
    workers: list            # rank 0: the other ranks' processes


class Averaged:
    """A training system whose step returns the losses averaged over the
    ranks: what `train.drive` reads in the checked steps"""

    def __init__(self, system, core, mesh):
        self.system, self.core, self.mesh = system, core, mesh
        self.trainer = system.trainer

    @property
    def output(self):
        return self.system.output

    def watch(self):
        self.system.watch()

    def step(self, batch):
        metrics = self.core.average_metrics(
            self.core.train_step(self.trainer, batch), self.mesh)
        return (metrics['loss/generator/total'],
                metrics['loss/discriminator/total'])


@dataclasses.dataclass
class State:
    batches: list            # the global batches (rank 0) or None
    shards: list             # this rank's rows of each
    states: dict
    system: object
    readings: object
    group: object
    next: int = 0


def free_port():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def join(rank, world, port, device):
    """Join the process group; returns the `Group` (without workers)"""
    import torch.distributed as dist
    from promonet_tpu_torch import parallel
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    # One host: the loopback interface, whatever else the host has
    for variable in ('NCCL_SOCKET_IFNAME', 'GLOO_SOCKET_IFNAME'):
        os.environ.setdefault(variable, 'lo')
    dist.init_process_group(
        backend, init_method=f'tcp://localhost:{port}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    flags = dist.new_group(backend='gloo')
    mesh = parallel.create_mesh({'data': world}, device=device)
    return Group(rank, world, mesh, flags, [])


def pin(rank, world, device):
    """Bind this process to its share of the CPUs it may use: whole
    physical cores (siblings by the host's topology, where readable),
    dealt to the ranks in contiguous blocks, and as many intra-op threads.
    Four ranks launch their steps from one host: unbound, two ranks'
    launching threads can share a core and slow the step of all four. On
    the CPU, where the ranks compute the steps themselves, nothing is
    bound; returns None there."""
    if device.type != 'cuda':
        return None
    cores = {}
    for cpu in sorted(os.sched_getaffinity(0)):
        topology = Path(f'/sys/devices/system/cpu/cpu{cpu}/topology')
        try:
            key = tuple((topology / name).read_text().strip()
                        for name in ('physical_package_id', 'core_id'))
        except OSError:
            key = (cpu,)
        cores.setdefault(key, []).append(cpu)
    groups = list(cores.values())
    share = max(1, len(groups) // world)
    mine = groups[rank * share:(rank + 1) * share] or groups
    cpus = [cpu for group in mine for cpu in group]
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(len(cpus))
    return cpus


def barrier(device):
    """All ranks' work so far done: an all-reduce on the device, then a
    synchronize"""
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1, device=device))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def spawn(context, world, port):
    """Start ranks 1 .. world - 1, each on its own card"""
    environment = dict(os.environ)
    environment['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + ([environment['PYTHONPATH']]
                       if environment.get('PYTHONPATH') else []))
    return [subprocess.Popen(
        [sys.executable, '-m', 'portbench.drivers.train_dp',
         '--root', str(context.cell.root), '--workload', context.cell.name,
         '--seed', str(context.seed), '--rank', str(rank), '--world',
         str(world), '--port', str(port), '--device', context.device.type],
        cwd=str(ROOT), env=environment, stdout=sys.stderr)
        for rank in range(1, world)]


def setup(context):
    """Rank 0's set-up: start the other ranks, join them, set up"""
    world = context.cell.traffic['world']
    if context.system != 'program':
        # The control trains on the whole global batch on one card
        return prepare(context, None)
    port = free_port()
    workers = spawn(context, world, port)
    try:
        group = join(0, world, port, context.device)
    except Exception:
        for worker in workers:
            worker.kill()
        raise
    group.workers = workers
    # After the start of the others, which take the whole set and pin
    # themselves
    harness.log(f'rank 0 on CPUs {pin(0, world, context.device)}')
    return prepare(context, group)


def prepare(context, group):
    """Every rank's set-up: weights, batches, the training state with the
    mesh, the checked steps and the warm-up, in lockstep"""
    import promonet_tpu_torch as port
    from promonet_tpu_torch import parallel
    from promonet_tpu_torch.train import core
    config, traffic = context.config, context.cell.traffic
    states = common.seeded_states(
        {'generator': port.models.Generator(config),
         'discriminator': port.models.Discriminator(config)},
        context.seed, context.device, context.cell.config_file)
    batches = train.make_batches(traffic, context.seed, config,
                                 context.device)
    if group is None:
        shards = batches
        system = train.Reference(context, states, FLOAT8)
        stepper = system
    else:
        shards = [parallel.shard_batch(batch, group.mesh)
                  for batch in batches]
        if group.rank:
            batches = None
        system = train.Program(context, states)
        system.trainer.mesh = group.mesh
        stepper = Averaged(system, core, group.mesh)
    readings = train.drive(stepper, shards[:traffic['checked_steps']],
                           config.OPTIMIZER.get('b1', .8))
    for index in range(traffic['warmup_steps']):
        system.step(shards[(traffic['checked_steps'] + index) % len(shards)])
    return State(batches, shards, states, system, readings, group)


def flag(group, go):
    """Rank 0 tells the others whether a step follows; every rank
    returns it"""
    import torch.distributed as dist
    value = torch.tensor([int(go)])
    dist.broadcast(value, 0, group=group.flags)
    return bool(value.item())


def run(context, state, seconds):
    """Rank 0's window: steps until `seconds` have passed, from a barrier
    of all ranks to a barrier after the last step"""
    traffic, tracer, group = context.cell.traffic, context.tracer, state.group
    first = traffic['checked_steps'] + traffic['warmup_steps']
    steps = 0
    with tracer.window():
        if group is not None:
            barrier(context.device)
        start = time.perf_counter()
        deadline = start + seconds
        while group is None and time.perf_counter() < deadline or \
                group is not None and flag(
                    group, time.perf_counter() < deadline):
            with tracer.range('step'):
                state.system.step(
                    state.shards[(first + steps) % len(state.shards)])
            steps += 1
        if group is not None:
            barrier(context.device)
        elif context.device.type == 'cuda':
            torch.cuda.synchronize()
        end = time.perf_counter()
    state.next = first + steps
    rows = state.shards[0]['audio'].shape[0]
    work = {'steps': steps, 'rows': rows, 'samples': traffic['chunk']}
    return harness.Window(steps, 0, end - start,
                          {'train_step_ms': 1e3 * (end - start) /
                           max(steps, 1)}, work)


def follow(context, state):
    """Ranks 1 ..: the window's steps, as rank 0 announces them"""
    traffic, group = context.cell.traffic, state.group
    first = traffic['checked_steps'] + traffic['warmup_steps']
    steps = 0
    barrier(context.device)
    while flag(group, False):
        state.system.step(state.shards[(first + steps) % len(state.shards)])
        steps += 1
    barrier(context.device)
    state.next = first + steps


def differing(trainer, group, device):
    """Values of the parameters in which some rank differs from rank 0,
    bit for bit"""
    import torch.distributed as dist
    flat = torch.cat([value.detach().reshape(-1).view(torch.int32)
                      for _, value in sorted(train.leaves(trainer).items())])
    first = flat.clone()
    dist.broadcast(first, 0)
    count = (flat != first).sum().reshape(1).to(torch.int64)
    dist.all_reduce(count)
    return int(count.item())


def after_window(context, state):
    """Every rank, after the window: the parameters compared, then the
    checked steps from the window's state; rank 0 returns (the number
    of differing values, the snapshot the steps start from, their
    readings)"""
    traffic = context.cell.traffic
    group, system = state.group, state.system
    differ = differing(system.trainer, group, context.device)
    after = [state.shards[(state.next + index) % len(state.shards)]
             for index in range(traffic['checked_steps'])]
    saved = train.snapshot(system.trainer) if group.rank == 0 else None
    from promonet_tpu_torch.train import core
    timed = train.drive(Averaged(system, core, group.mesh), after,
                        context.config.OPTIMIZER.get('b1', .8))
    return differ, saved, timed


def leave(group):
    """Leave the process group; rank 0 waits for the others' exit"""
    import torch.distributed as dist
    dist.destroy_process_group()
    failed = []
    for worker in group.workers:
        try:
            code = worker.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            worker.kill()
            code = 'killed'
        if code != 0:
            failed.append(code)
    if failed:
        raise RuntimeError(f'ranks ended with {failed}')


def check(context, state, window):
    """The numbers of `train.check`, rank 0 against the reference on the
    whole global batch, and `ranks_differ`"""
    traffic = context.cell.traffic
    beta1 = context.config.OPTIMIZER.get('b1', .8)
    count = traffic['checked_steps']
    numbers = {}
    after = [state.batches[(state.next + index) % len(state.batches)]
             for index in range(count)]
    if state.group is None:
        saved = train.snapshot(state.system.trainer)
        timed = train.drive(state.system, after, beta1)
    else:
        numbers['ranks_differ'], saved, timed = after_window(context, state)
        leave(state.group)
    rows = state.shards[0]['audio'].shape[0]
    state.system = None
    if context.device.type == 'cuda':
        torch.cuda.empty_cache()
    start = train.drive(train.Reference(context, state.states, EXACT),
                        state.batches[:count], beta1)
    reference = train.Reference(context, state.states, EXACT)
    train.restore(reference.trainer, saved)
    window_reference = train.drive(reference, after, beta1)
    for suffix, ours, theirs in (('', state.readings, start),
                                 ('.window', timed, window_reference)):
        # Rank 0's audio is its own rows of the global batch's
        theirs = dataclasses.replace(theirs, output=theirs.output[:rows])
        train.log_gaps(suffix, ours, theirs)
        numbers.update({name + suffix: value for name, value in
                        train.compare(ours, theirs).items()})
    return numbers


def main(argv=None):
    """A rank other than 0: set up, follow the window, take the checked
    steps, leave"""
    parser = argparse.ArgumentParser(description='One rank of train_dp')
    for name in ('--root', '--workload', '--device'):
        parser.add_argument(name, required=True)
    for name in ('--seed', '--rank', '--world', '--port'):
        parser.add_argument(name, type=int, required=True)
    arguments = parser.parse_args(argv)
    if arguments.device == 'cuda':
        torch.cuda.set_device(arguments.rank)
        device = torch.device('cuda', arguments.rank)
    else:
        device = torch.device('cpu')
    harness.log(f'rank {arguments.rank} on CPUs '
                f'{pin(arguments.rank, arguments.world, device)}')
    cell = harness.Cell(harness.load_benchmark(arguments.root),
                        arguments.workload, arguments.root)
    context = harness.Context(cell, cell.config(), arguments.seed, device,
                              trace.Tracer(0))
    group = join(arguments.rank, arguments.world, arguments.port, device)
    try:
        state = prepare(context, group)
        follow(context, state)
        after_window(context, state)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
