"""The row-sharded lookup: rows of a table split over the ``model`` axis.

Under a mesh whose ``model`` axis is wider than one, each rank of a model
group holds rows ``[offset, offset + L)`` of every padded embedding table
(``parallel/mesh.py::shard_params``). JAX leaves the lookup to XLA, which
inserts the collective from the sharding annotations; here it is explicit:

- forward: each rank gathers the rows it owns (zeros for the others), then
  one ``all_reduce(SUM)`` over the model group hands every rank all rows;
- backward: each rank adds the upstream rows it owns into its shard's
  gradient, each row's in position order (``ops/row_groups.py::row_sum``
  over the grouping of the ids by the shard's rows: on the card no float
  atomic, so the sums repeat run to run). Every rank of the group computed
  the same loss from the same rows, so no collective is needed there; the
  data-parallel sum of the gradients follows in the train step.
"""

import torch
import torch.distributed as dist

from recbole_cdr_tpu_torch.ops.row_groups import RowPlan, group_rows, row_sum

#: per (device, shard rows, shard offset), the kept plan of the backward's
#: grouping
_PLANS = {}


class _ShardedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, offset, group):
        local = ids.long() - offset
        own = (local >= 0) & (local < shard.shape[0])
        safe = torch.where(own, local, 0)
        rows = torch.where(own[:, None], shard[safe], 0).contiguous()
        dist.all_reduce(rows, group=group)
        ctx.save_for_backward(ids.to(torch.int32))
        ctx.offset, ctx.n_rows = offset, shard.shape[0]
        return rows

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        key = (ids.device, ctx.n_rows, ctx.offset)
        plan = _PLANS.get(key)
        if plan is None:
            plan = _PLANS[key] = RowPlan(ctx.n_rows, ids.device, ctx.offset, ids.shape[0])
        groups = group_rows(ids, plan)
        return row_sum(grad.contiguous(), ids, groups), None, None, None


def sharded_lookup(shard: torch.Tensor, ids: torch.Tensor, offset: int, group) -> torch.Tensor:
    """Rows ``ids`` (global row ids, any integer type) of the table whose rows
    ``[offset, offset + len(shard))`` this rank holds as ``shard``, gathered
    over ``group`` (the model group); differentiable in ``shard``."""
    return _ShardedLookup.apply(shard, ids, offset, group)
