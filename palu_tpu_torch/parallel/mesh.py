"""Device meshes over torch.distributed (port of the mesh half of
palu_tpu/parallel/mesh.py).

A mesh is a torch.distributed DeviceMesh whose processes (one card each,
or one CPU process under gloo) are laid out as (data, model), or as
(data, seq) for the sequence-parallel decode (the JAX tests build
Mesh(devices, ("data", "seq"))). `data` shards the batch lanes; `seq`
shards every cache leaf along the sequence, and each decode layer merges
the shards with the flash-decoding combine (ops/attention.py); `model`
would shard head groups (tensor parallelism), which comes with a later
slice: the engine refuses a mesh whose model axis is larger than 1.

The JAX package's param_shardings / cache_shardings / shard_tree
(NamedSharding trees for GSPMD) and shard_map_nocheck have no counterpart:
here each process slices its own cache on the host (runtime/cache.py) and
holds the weights whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "axis_group", "world_size"]


def world_size() -> int:
    """Processes in the default group (1 before torch.distributed starts)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: int = 1, model: int = 1, *, seq: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh, or with `seq` a (data, seq) one (model must
    then be 1), over all processes of the default group, which must
    number exactly data * model (or data * seq). Raises ValueError when
    the mesh needs more processes than there are, as the JAX make_mesh
    does for devices."""
    if seq is not None and model != 1:
        raise ValueError("a mesh has either a model or a seq axis, not both")
    second, name = (model, "model") if seq is None else (seq, "seq")
    if data < 1 or second < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, {name}={second}")
    n, world = data * second, world_size()
    if n > world:
        raise ValueError(f"mesh {data}x{second} needs {n} processes, have {world}")
    if n != world:
        raise ValueError(f"mesh {data}x{second} must cover all {world} processes")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "parallel.initialize_multihost or init_process_group first")
    return init_device_mesh(device_type, (data, second), mesh_dim_names=("data", name))


def axis_group(mesh: DeviceMesh, axis: str) -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, this process's index, size) along one mesh axis."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {axis!r}")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.shape[dim]
