"""The row-sharded lookup: rows of a table split over the ``model`` axis.

Under a mesh whose ``model`` axis is wider than one, each rank of a model
group holds rows ``[offset, offset + L)`` of every padded embedding table
(``parallel/mesh.py::shard_params``). JAX leaves the lookup to XLA, which
inserts the collective from the sharding annotations; here it is explicit:

- forward: each rank gathers the rows it owns (zeros for the others), then
  one ``all_reduce(SUM)`` over the model group hands every rank all rows;
- backward: each rank scatter-adds the upstream rows it owns into its
  shard's gradient. Every rank of the group computed the same loss from the
  same rows, so no collective is needed there; the data-parallel sum of the
  gradients follows in the train step.
"""

import torch
import torch.distributed as dist


class _ShardedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, offset, group):
        local = ids.long() - offset
        own = (local >= 0) & (local < shard.shape[0])
        safe = torch.where(own, local, 0)
        rows = torch.where(own[:, None], shard[safe], 0).contiguous()
        dist.all_reduce(rows, group=group)
        ctx.save_for_backward(safe, own)
        ctx.shard_shape = shard.shape
        return rows

    @staticmethod
    def backward(ctx, grad):
        safe, own = ctx.saved_tensors
        out = torch.zeros(ctx.shard_shape, dtype=grad.dtype, device=grad.device)
        out.index_add_(0, safe[own], grad[own])
        return out, None, None, None


def sharded_lookup(shard: torch.Tensor, ids: torch.Tensor, offset: int, group) -> torch.Tensor:
    """Rows ``ids`` (global row ids, any integer type) of the table whose rows
    ``[offset, offset + len(shard))`` this rank holds as ``shard``, gathered
    over ``group`` (the model group); differentiable in ``shard``."""
    return _ShardedLookup.apply(shard, ids, offset, group)
