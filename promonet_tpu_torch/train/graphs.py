"""The training step replayed as CUDA graphs, one graph a phase

A step is graphed where nothing it does hides from a graph, and only on
a CUDA device. Its key (`key`) is the batch's shapes and dtypes,
`discriminate`, `adversarial`, and the tensors the step reads and
updates (each leaf and optimizer state tensor by address, and the
optimizers' settings). The first step of a
key runs eagerly: it is a real step and the warm-up (cuDNN's and
cuBLAS's plans, AdamW's lazy state, the caches of the step's constants,
the communicator). The next step of the same key is captured as one CUDA
graph a phase (`train.generator`, `train.discriminator`, `train.losses`,
`train.backward`, `train.optimizer`), on one capture stream and in one
memory pool, autograd's state carried from the first graph to the
fourth as in `torch.cuda.make_graphed_callables`, and is replayed at
once; later steps of the key replay, each graph inside its phase's span.
A key that changes (the loss warm-up's switches, a host loader's last
short batch, a checkpoint loaded into new optimizer state) drops the
graphs, and that step runs eagerly.

A step runs eagerly where `graphable` says no: a parameter, or an input,
off a CUDA device; a noise source given to the step (a callable the
graph cannot see into); an optimizer other than Adam or AdamW, which
cannot be made capturable; a module hook that a graph would fire at
capture only (a global one, a forward pre-hook or a backward hook on
either model or any module in them, a forward hook on any module but the
generator itself); a mesh with a process group, whose all-reduces do not
hold inside graphs: on four H100s under NCCL every run with them
captured hung (a single rank's held). Adam and AdamW are capturable
exactly while the steps may be graphed (`capturable`): capturable, their
bias corrections take about 470 more launches a step, which only a
replay takes off the host.

What callers see is what an eager step gives: the generator's forward
hooks are called once a step, after its graph's replay, with the
generator, the step's own inputs and a copy of the output the replay
wrote (never during capture); the metrics are one copy of the graph's
stacked metric buffer, split into views, so a caller that holds a
step's metrics never sees the next step's.
"""
import collections

import torch
from torch.nn.modules import module as module_module

from ..utils import timer


class Graphs:
    """The graphs of one key: none until `capture`

    key: the `key` of the steps they replay
    phases: [(phase name, `torch.cuda.CUDAGraph`)] once captured
    replays: the steps that graphs of any key ran, in this process
    """

    replays = 0

    def __init__(self, key):
        self.key = key
        self.phases = None

    def capture(self, state, batch, build, rng=None):
        """Capture the step that `build(batch)` lays out, reading the
        batch's tensors from copies that every replay refills

        build: called with the static batch; returns (work, [(phase
            name, callable)]), the callables running the step's phases in
            order and leaving `work.raw` (the generator's output) and
            `work.metrics` ({name: float32 scalar}) on `work`
        rng: a `torch.Generator` that the first phase draws from, or None
        """
        static = {name: value.clone() if torch.is_tensor(value) else value
                  for name, value in batch.items()}
        work, steps = build(static)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device=state.device)
        generator = state.generator
        hooks, generator._forward_hooks = (
            generator._forward_hooks, collections.OrderedDict())
        phases = []
        try:
            for index, (name, run) in enumerate(steps):
                graph = torch.cuda.CUDAGraph()
                if rng is not None and index == 0:
                    graph.register_generator_state(rng)
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    run()
                    if index == len(steps) - 1:
                        buffer = torch.stack(list(work.metrics.values()))
                phases.append((name, graph))
        finally:
            generator._forward_hooks = hooks
        self.inputs = {name: value for name, value in static.items()
                       if torch.is_tensor(value)}
        # Detached: the capture's autograd graph, which holds the leaves'
        # gradient accumulators on the capture stream, goes with it
        self.output, self.buffer = work.raw.detach(), buffer
        self.names = list(work.metrics)
        self.phases = phases

    def replay(self, state, batch, generator_inputs):
        """One step by the graphs: the batch copied in, each graph
        replayed inside its phase's span, the generator's forward hooks
        called after the first; returns the step's metrics

        generator_inputs: called with the batch, gives the generator's
            (args, kwargs) as an eager step calls it
        """
        with torch.no_grad():
            for name, buffer in self.inputs.items():
                buffer.copy_(batch[name])
        generator = state.generator
        for name, graph in self.phases:
            with timer.span('train.' + name):
                graph.replay()
                if name == 'generator' and generator._forward_hooks:
                    call_forward_hooks(
                        generator, *generator_inputs(batch),
                        self.output.clone())
        Graphs.replays += 1
        return dict(zip(self.names, self.buffer.clone().unbind()))


def call_forward_hooks(module, args, kwargs, output):
    """Call `module`'s forward hooks as its call would after its forward
    pass; a hook may not replace the output, which the graphs have
    already passed on"""
    for hook_id, hook in list(module._forward_hooks.items()):
        if hook_id in module._forward_hooks_with_kwargs:
            result = hook(module, args, kwargs, output)
        else:
            result = hook(module, args, output)
        if result is not None:
            raise RuntimeError(
                'A forward hook of the generator returned a value in a '
                'replayed training step, which cannot replace the output '
                'the graph passed on; register it as a forward pre-hook '
                'too, which keeps the steps eager')


def key(state, batch, discriminate, adversarial):
    """What a step's graphs are captured for: the batch's tensors' names,
    shapes, dtypes and devices, the two switches and `held(state)`"""
    tensors = tuple(sorted(
        (name, tuple(value.shape), value.dtype, value.device)
        for name, value in batch.items() if torch.is_tensor(value)))
    return tensors, bool(discriminate), bool(adversarial), held(state)


def held(state):
    """The addresses of the tensors a step reads and updates in place (the
    trainable leaves, the discriminators' parameters, both optimizers'
    state) and the optimizers' settings, which a graph holds as
    constants: a tensor swapped for another or a changed setting changes
    it"""
    leaves = [state.trainable[name] for name in state.names] + list(
        state.discriminator.parameters())
    out = [leaf.data_ptr() for leaf in leaves]
    for optimizer in _optimizers(state):
        for group in optimizer.param_groups:
            out.append(tuple(
                (name, value) for name, value in sorted(group.items())
                if name != 'params'))
            for parameter in group['params']:
                out.extend(
                    value.data_ptr() for value in
                    optimizer.state.get(parameter, {}).values()
                    if torch.is_tensor(value))
    return tuple(out)


def graphable(state, batch, noise):
    """Whether a step may be graphed (the module's docstring says when
    not)"""
    return (
        state.device.type == 'cuda'
        and all(value.device == state.device for value in batch.values()
                if torch.is_tensor(value))
        and noise is None
        and all('capturable' in group for optimizer in _optimizers(state)
                for group in optimizer.param_groups)
        and not _hooked(state)
        and not (state.mesh is not None and state.mesh.group))


def capturable(state, on):
    """Put Adam and AdamW into capturable mode or take them out of it,
    their step counts moved to the parameters' device or the host with
    them; a no-op where they are in that mode already"""
    for optimizer in _optimizers(state):
        for group in optimizer.param_groups:
            if group.get('capturable', on) == on:
                continue
            group['capturable'] = on
            for parameter in group['params']:
                saved = optimizer.state.get(parameter, {})
                if 'step' in saved:
                    saved['step'] = saved['step'].to(
                        parameter.device if on else 'cpu')


def _optimizers(state):
    return state.generator_optimizer, state.discriminator_optimizer


def _hooked(state):
    """Whether a hook fires that a replay would not call"""
    if (module_module._global_forward_hooks or
            module_module._global_forward_pre_hooks or
            module_module._global_backward_hooks or
            module_module._global_backward_pre_hooks):
        return True
    for model in (state.generator, state.discriminator):
        for module in model.modules():
            if (module._forward_pre_hooks or module._backward_hooks or
                    module._backward_pre_hooks or
                    module._forward_hooks and module is not state.generator):
                return True
    return False
