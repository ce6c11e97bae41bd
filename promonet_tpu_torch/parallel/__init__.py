"""Data-parallel training over `torch.distributed` and the tensor-parallel
specifications (counterpart of `promonet_tpu/parallel/`)"""
from .mesh import (
    Mesh,
    all_reduce_mean,
    batch_sharding,
    create_mesh,
    feature_dims,
    parameter_shardings,
    replicate_batch,
    replicated_sharding,
    shard_batch,
    shard_parameters,
    shard_pytree)
