"""The device mesh (counterpart of scldm_tpu/parallel/mesh.py).

The reference's only multi-card layout is DDP over NCCL; JAX's is a named
mesh, ("data", "model"), whose "data" axis carries the batch. The port's mesh
is a `torch.distributed.device_mesh.DeviceMesh` over every rank with the same
axis names, the "model" axis the inner one (ranks d * n_model + m), as JAX's
`reshape(n_data, n_model)`. The tasks read their process groups from it.
On one process the CLIs pass `mesh=None`, as JAX's do on one device. The
"model" axis carries gene-SP, the GPipe trunk's stages or Megatron's
parameter slices, as the task's keys choose (`parallel/gene_sp.py`,
`pipeline.py`, `sharding_rules.py`).

`shard_batch` and `shard_stacked_batch` return a rank's rows of a global
batch (the tests use them); under the CLIs each rank already loads its own
rows (the DataModule's host split), JAX's multi-host `shard_batch`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh with axes ("data", "model") over every rank; `n_data` defaults
    to the world size over `n_model`. Its device type follows the backend
    (cuda under NCCL, cpu under gloo) unless given. Needs a process group
    (`distributed.maybe_initialize_distributed`)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed up (maybe_initialize_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {world} ranks")
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def _rows(x, lo: int, hi: int, axis: int):
    return x[lo:hi] if axis == 0 else x[:, lo:hi]


def _shard(batch: Dict, mesh: DeviceMesh, axis: int) -> Dict:
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    size = next(iter(batch.values())).shape[axis]
    if size % n:
        raise ValueError(f"a batch of {size} rows does not split over {n} data ranks")
    b = size // n
    return {k: _rows(v, r * b, (r + 1) * b, axis) for k, v in batch.items()}


def shard_batch(batch: Dict, mesh: DeviceMesh) -> Dict:
    """This rank's rows of a global batch dict (tensors or arrays): the
    batch axis split evenly over "data" in rank order; the "model" ranks of
    one data rank hold the same rows."""
    return _shard(batch, mesh, 0)


def shard_stacked_batch(stacked: Dict, mesh: DeviceMesh) -> Dict:
    """`shard_batch` of a (K, batch, ...) stacked batch: the step axis whole,
    the batch axis split over "data"."""
    return _shard(stacked, mesh, 1)
