"""The mesh of processes: ``torch.distributed`` set-up and placement
(``distributed``), the (data, model) mesh and its sharding rules (``mesh``),
and the row-sharded lookup (``embedding``). Port of
``recbole_cdr_tpu/parallel``."""

from recbole_cdr_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    param_sharding_rules,
    shard_params,
)

__all__ = [
    "make_mesh",
    "param_sharding_rules",
    "shard_params",
    "make_sharded_train_step",
]
