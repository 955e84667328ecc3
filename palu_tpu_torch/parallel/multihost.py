"""Process bootstrap and host-local data feeding (port of
palu_tpu/parallel/multihost.py).

One process drives one card (or one CPU share under gloo). Nothing tells a
process of its cluster: `initialize_multihost` takes the address, the
process count and this process's rank from its arguments or from
torch's own environment names (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK). The backend follows the engine's device: NCCL for CUDA, gloo for
the CPU; a caller may name another (two processes that share one card
need gloo, since NCCL refuses two ranks on one device). A failure raises;
no other backend is tried.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import make_mesh, world_size

__all__ = ["initialize_multihost", "make_pod_mesh", "host_local_batch_slice",
           "default_backend"]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, device="cuda",
                         backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group over tcp://coordinator_address
    ("host:port"; default MASTER_ADDR:MASTER_PORT) with num_processes
    (WORLD_SIZE) processes, this one process_id (RANK). No-op with one
    process. On CUDA each process takes the card LOCAL_RANK (default: its
    rank modulo the cards there are)."""
    if num_processes in (None, 1) and os.environ.get("WORLD_SIZE", "1") == "1":
        return
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    addr = coordinator_address or f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if torch.device(device).type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend or default_backend(device), init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)


def make_pod_mesh(model_parallelism: int, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over every process: `model` consecutive ranks
    per data row, `data` the rest."""
    world = world_size()
    if model_parallelism < 1 or world % model_parallelism:
        raise ValueError(f"{world} processes not divisible by model={model_parallelism}")
    return make_mesh(world // model_parallelism, model_parallelism, device_type=device_type)


def host_local_batch_slice(global_batch: int, mesh: DeviceMesh) -> slice:
    """The rows of the global batch this process feeds: its coordinate on
    the data axis owns global_batch / data consecutive lanes."""
    n_data = mesh.shape[mesh.mesh_dim_names.index("data")]
    if global_batch % n_data:
        raise ValueError(f"batch {global_batch} does not split over data={n_data}")
    per = global_batch // n_data
    i = mesh.get_local_rank("data")
    return slice(i * per, (i + 1) * per)
