"""Parallel layouts over ``torch.distributed`` (counterpart of
``ngsxfem_tpu/parallel``): element sharding of meshes and spaces, the
dof partition of the halo layout, the lattice-slab DIA operator, and the
multi-rank dry run of the flagship's layouts."""
from .halo import DofPartition
from .latticeshard import LatticeShard
from .sharding import (ShardGroup, backend_for, device_mesh, element_chunks,
                       init_group, rank_device, replicate, shard_mesh,
                       shard_space, spawn_ranks)
from .dryrun import dryrun_multichip

__all__ = ["DofPartition", "LatticeShard", "ShardGroup", "backend_for",
           "device_mesh", "element_chunks", "init_group", "rank_device",
           "replicate", "shard_mesh", "shard_space", "spawn_ranks",
           "dryrun_multichip"]
