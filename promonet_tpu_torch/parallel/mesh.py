"""Process-mesh parallelism (counterpart of `promonet_tpu/parallel/mesh.py`)

The JAX package lays one process's devices out as a `jax.sharding.Mesh`
and lets XLA insert the collectives. The port runs one process per card
(`torchrun`), so its mesh is a small record of the axis sizes, this
process's rank in the world and its device, built from the
`torch.distributed` process group where one is initialised and otherwise
a world of one, which needs no process group at all.

Training is data-parallel, as in the JAX package: the global batch is
split over the 'data' axis (`shard_batch`), parameters and optimizer
state are the same on every rank (`shard_pytree` broadcasts rank 0's),
and the trainer averages each model's gradients over the world as one
flat bucket (`all_reduce_mean`) before its clip and optimizer step.

`parameter_shardings` and `shard_parameters` are the tensor-parallel
specifications of the JAX package, public there and unused by its
trainer: with a 'model' axis, each kernel whose output-feature axis is
at least `min_size` and divides over the axis is sharded along it
(`torch.distributed.tensor`), every other parameter replicated.
"""
import math

import numpy as np
import torch

from .. import config as config_module
from .. import device as device_module
from ..utils import timer


class Mesh:
    """Axis sizes ({name: size}, in order), this process's rank and the
    world's size, and this process's device

    `group` is True when the mesh was built from an initialised process
    group: then its collectives are issued even in a world of one.
    """

    def __init__(self, shape, rank=0, world=1, device='cpu', group=False):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.group = group

    def size(self, axis):
        """The size of an axis, 1 for an axis the mesh does not have"""
        return self.shape.get(axis, 1)

    def coordinate(self, axis):
        """This rank's index along `axis` (ranks are laid out row-major
        over the axes, as `np.arange(world).reshape(sizes)`)"""
        if axis not in self.shape:
            return 0
        sizes = tuple(self.shape.values())
        return int(np.unravel_index(self.rank, sizes)[
            self.axis_names.index(axis)])

    def device_mesh(self):
        """The `torch.distributed.device_mesh.DeviceMesh` of this mesh
        (needs the process group)"""
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(
            self.device.type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)

    def __repr__(self):
        return (f'Mesh({self.shape}, rank={self.rank}, world={self.world}, '
                f'device={self.device})')


def _distributed():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def create_mesh(shape=None, config=None, device='cuda'):
    """The mesh of this process

    Arguments
        shape: {axis name: size}, e.g. {'data': 4}; None takes
            config.MESH_SHAPE, and None there puts the whole world on the
            'data' axis
        config: a `config.Config`; None reads the environment's
        device: this process's device ('cuda' raises on a host without a
            card)

    The world is the initialised `torch.distributed` process group's, else
    one process. Raises ValueError when the shape's sizes do not multiply
    to the world's size.
    """
    config = config_module.default() if config is None else config
    device = device_module.resolve(device)
    dist = _distributed()
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)
    if shape is None:
        shape = config.MESH_SHAPE
    if shape is None:
        shape = {'data': world}
    if math.prod(shape.values()) != world:
        raise ValueError(
            f'Mesh shape {shape} holds {math.prod(shape.values())} '
            f'processes, and the world has {world}')
    return Mesh(shape, rank, world, device, group=dist is not None)


def batch_sharding(mesh, axis='data'):
    """The `torch.distributed.tensor` placements of a batch: its leading
    axis split over `axis`, replicated over the others"""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(
        Shard(0) if name == axis else Replicate() for name in mesh.axis_names)


def replicated_sharding(mesh):
    """The placements of a tensor every rank holds whole (parameters,
    optimizer state)"""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.axis_names)


def _rows(value, part, parts):
    """Block `part` of `parts` of value's leading axis"""
    size = len(value) // parts
    if size * parts != len(value):
        raise ValueError(
            f'A batch of {len(value)} does not divide over {parts} ranks')
    return value[part * size:(part + 1) * size]


def shard_batch(batch, mesh, axis='data'):
    """This rank's rows of a global batch: the batch split into
    mesh.size(axis) contiguous blocks along its leading axis, and block
    mesh.coordinate(axis) kept, as the JAX package's PartitionSpec(axis)
    places them; arrays, tensors and lists are split, other values kept"""
    parts, part = mesh.size(axis), mesh.coordinate(axis)
    return {
        key: _rows(value, part, parts)
        if isinstance(value, (np.ndarray, torch.Tensor, list)) else value
        for key, value in batch.items()}


def replicate_batch(batch, mesh):
    """The whole batch, its arrays as tensors on this rank's device (every
    rank holds all of it: validation's batches of one, which do not
    divide over the 'data' axis)"""
    return {
        key: torch.as_tensor(value).to(mesh.device)
        if isinstance(value, (np.ndarray, torch.Tensor)) else value
        for key, value in batch.items()}


def shard_pytree(tree, mesh):
    """Rank 0's values of every tensor in a (nested dict, list or tuple)
    tree, in place on every rank: parameters and optimizer state start
    the same everywhere; returns the tree"""
    dist = _distributed()
    if dist is None or mesh.world == 1:
        return tree
    for tensor in _tensors(tree):
        with torch.no_grad():
            dist.broadcast(tensor.data, src=0)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def all_reduce_mean(tensors, mesh):
    """The mean over the world of each tensor (one model's gradients), as
    one flat all-reduce; the tensors as they are where mesh is None or was
    built without a process group

    Each issued all-reduce adds one to `all_reduce_mean.launches` and is
    the span `train.allreduce` (count `values`, the elements reduced).
    """
    dist = _distributed()
    if dist is None or mesh is None or not mesh.group:
        return list(tensors)
    flat = torch.cat([tensor.reshape(-1) for tensor in tensors])
    with timer.span('train.allreduce', values=flat.numel()):
        dist.all_reduce(flat)
    all_reduce_mean.launches += 1
    flat /= mesh.world
    out, offset = [], 0
    for tensor in tensors:
        out.append(flat[offset:offset + tensor.numel()].view_as(tensor))
        offset += tensor.numel()
    return out


all_reduce_mean.launches = 0


###############################################################################
# Tensor-parallel specifications
###############################################################################


def feature_dims(module):
    """{parameter name: the dim of the port's layout that holds the JAX
    kernel's trailing (output-feature) axis, or None} of a module

    The JAX package's kernels are (k, in, out), (kh, kw, in, out) and (in,
    out), with their weight-norm g of the same rank; the bridge
    (`models.bridge`) lays them out as PyTorch's (out, in, k), (out, in,
    kh, kw) and (out, in) (dim 0), the transposed convolutions' (in, out,
    k) (dim 1), the residual Blocks' stacked (6, k, in, out) (dim 3) and
    embedding tables unchanged (dim 1). Biases, norms' scales and the
    Blocks' stacked biases are vectors in the JAX package: None.
    """
    from ..models.hifigan import Block
    from ..models.modules import ConvTranspose1d

    dims = {}
    for prefix, submodule in module.named_modules():
        for name, parameter in submodule.named_parameters(recurse=False):
            if parameter.ndim < 2 or name == 'bias':
                dim = None
            elif isinstance(submodule, Block):
                dim = 3
            elif isinstance(submodule, (ConvTranspose1d, torch.nn.Embedding)):
                dim = 1
            else:
                dim = 0
            dims[f'{prefix}.{name}' if prefix else name] = dim
    return dims


def parameter_shardings(module, mesh, axis='model', min_size=64,
                        parameters=None):
    """{parameter name: placements} for `torch.distributed.tensor`: one
    `Shard(dim)` or `Replicate()` per axis of the mesh

    parameters: {name: tensor} to place, by default the module's own; a
    trainable set's `<name>_v` and `<name>_g` (`models.modules.split`)
    take `<name>`'s dim. A parameter is sharded along `axis` at its
    `feature_dims` dim when that dim has at least `min_size` entries and
    divides over the axis; everything else, and everything when the mesh
    has no such axis, is replicated.
    """
    from torch.distributed.tensor import Replicate, Shard

    dims = feature_dims(module)
    if parameters is None:
        parameters = dict(module.named_parameters())
    size = mesh.shape.get(axis)
    shardings = {}
    for name, parameter in parameters.items():
        key = name
        if key not in dims and key[-2:] in ('_v', '_g'):
            key = key[:-2]
        dim = dims[key]
        sharded = (
            size is not None and dim is not None and
            parameter.shape[dim] >= min_size and
            parameter.shape[dim] % size == 0)
        shardings[name] = tuple(
            Shard(dim) if sharded and mesh_axis == axis else Replicate()
            for mesh_axis in mesh.axis_names)
    return shardings


def shard_parameters(module, mesh, axis='model', min_size=64,
                     parameters=None):
    """{parameter name: DTensor} placed by `parameter_shardings` on the
    mesh's `DeviceMesh` (needs the process group)"""
    from torch.distributed.tensor import distribute_tensor

    if parameters is None:
        parameters = dict(module.named_parameters())
    shardings = parameter_shardings(
        module, mesh, axis, min_size, parameters)
    device_mesh = mesh.device_mesh()
    return {
        name: distribute_tensor(
            value.detach().to(mesh.device), device_mesh, shardings[name])
        for name, value in parameters.items()}
