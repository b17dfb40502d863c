"""Multi-process orchestration and per-rank data placement.

Port of ``recbole_cdr_tpu/parallel/distributed.py``. JAX runs one process per
host over all of its devices; the port follows PyTorch's idiom instead: one
process per device, joined by a ``torch.distributed`` process group whose
world size is the mesh's data x model. The backend follows the device (NCCL
for the card, gloo for the CPU).

Execution model, as in JAX: every process runs the IDENTICAL program (same
config, same seed, same deterministic data pipeline), so every rank builds
the same global batch; the placement helpers then hand each rank its part:

- :func:`put_replicated`: read-only operands, the same value on every rank;
- :func:`put_sharded`: per-step batches, this rank's contiguous slice of the
  global batch along ``data``;
- :func:`fetch_replicated`: the parameters, row-sharded tables gathered over
  ``model``, as host numpy on every rank.

Enable with ``distributed: {coordinator_address, num_processes,
process_id}`` (``init_process_group(init_method="tcp://...")``), or
``distributed: auto`` for torchrun's environment (``env://``, the card of
``LOCAL_RANK``). ``mesh_shape`` without ``distributed`` runs a one-rank
group on this process.
"""

import os
from logging import getLogger
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from recbole_cdr_tpu_torch.utils.device import backend_for, rank_device, resolve_device


def initialize_distributed(device: torch.device, init_method: Optional[str] = None,
                           world_size: int = 1, rank: int = 0) -> dict:
    """Join (or, with no ``init_method``, create alone) the process group of
    the run on ``device``'s backend. Returns {rank, world_size, backend,
    device}, the rank's device resolved (``cuda`` -> ``cuda:<local rank>``)."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device)
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    info = {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "backend": backend, "device": str(device)}
    getLogger().info(f"torch.distributed: {info}")
    return info


def initialize_from_config(config) -> Optional[dict]:
    """Consume the ``distributed`` and ``mesh_shape`` config keys; must run
    before the dataset is built (``quick_start`` calls it first). Sets
    ``config["device"]`` to the rank's device. Returns None when the run
    needs no process group, or when the caller has set one up already (the
    run then uses it and leaves it to the caller)."""
    dist_cfg = config["distributed"]
    if not (dist_cfg or config["mesh_shape"]) or dist.is_initialized():
        return None
    device = resolve_device(config)
    if dist_cfg == "auto":
        info = initialize_distributed(device, "env://", int(_env("WORLD_SIZE")),
                                      int(_env("RANK")))
    elif dist_cfg:
        info = initialize_distributed(device, f"tcp://{dist_cfg['coordinator_address']}",
                                      int(dist_cfg["num_processes"]),
                                      int(dist_cfg["process_id"]))
    else:
        info = initialize_distributed(device)
    config["device"] = info["device"]
    return info


def _env(name: str) -> str:
    if name not in os.environ:
        raise RuntimeError(f"distributed: auto needs torchrun's {name} in the environment")
    return os.environ[name]


def shutdown() -> None:
    """Destroy the process group (every subgroup with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def put_replicated(x, mesh) -> torch.Tensor:
    """A host value (identical on every rank) on the rank's device."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def put_sharded(x, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a GLOBAL batch (identical on every rank) along
    ``dim``: the ``data`` index's chunk of ``torch.tensor_split`` (contiguous;
    the first chunks one longer when the length does not divide)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return torch.tensor_split(t, mesh.data, dim)[mesh.data_index].to(mesh.device)


def fetch_replicated(module, mesh) -> dict:
    """``{name: numpy array}`` of a module's parameters on every rank, each
    row-sharded table (``module.table_shards``) gathered over ``model`` and
    cut back to its rows."""
    shards = getattr(module, "table_shards", {})
    out = {}
    for name, p in module.named_parameters():
        p = p.detach()
        if name in shards:
            p = mesh.gather_rows(p)[:shards[name].rows]
        out[name] = p.cpu().numpy()
    return out
