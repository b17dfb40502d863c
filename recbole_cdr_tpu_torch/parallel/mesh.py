"""SPMD parallel layer: the (data, model) mesh of processes, the sharding
rules, the sharded train step.

Port of ``recbole_cdr_tpu/parallel/mesh.py``. JAX lays a ``Mesh`` with axes
``('data', 'model')`` over the devices of one program and lets XLA insert
the collectives; the port runs one process per device, so the mesh is the
rank's place in a process grid with explicit collectives:

- rank r sits at (r // model, r % model), the order of JAX's
  ``np.array(devices).reshape(d, m)``;
- a ``data`` group (the ranks that share a model index) and a ``model``
  group (the ranks that share a data index), every group created by every
  rank in the same order;
- embedding tables of at least ``MIN_SHARD_ROWS`` rows are padded to a
  multiple of ``model`` and row-sharded over it (each rank keeps rows
  ``[mi L, (mi + 1) L)``), the rest replicated; lookups go through
  ``parallel/embedding.py``;
- batches are split over ``data``; gradients are summed over the data group
  after the backward; under the row-sparse optimizer the occurrences of a
  step's rows and their gradient rows are gathered over it instead
  (:meth:`Mesh.gather_occurrences`), and each rank updates its own rows.

With one rank the collectives still run through the process group: no code
path special-cases a world of one.
"""

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from recbole_cdr_tpu_torch.parallel.distributed import put_sharded
from recbole_cdr_tpu_torch.parallel.embedding import sharded_lookup

#: embedding tables at least this many rows get row-sharded; smaller
#: parameters are replicated (sharding tiny tables costs more in collectives
#: than it saves)
MIN_SHARD_ROWS = 128

#: the id :meth:`Mesh.gather_occurrences` pads a short data slice's
#: occurrences with: past every shard of every table, so the row-sparse
#: update (kernel B6) skips it
OCCURRENCE_PAD = 2 ** 31 - 1


class TableShard(NamedTuple):
    """A row-sharded table on this rank: its rows before padding, and the
    global row of the shard's first row."""
    rows: int
    offset: int


class _BatchSum(torch.autograd.Function):
    """Sum over the data group forward; the identity backward, so each rank's
    gradient is its own slice's part of the global one."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Mesh:
    """This process's place in a ``data`` x ``model`` grid of ranks, with the
    groups of its row and column and the rank's device."""

    def __init__(self, data: int, model: int, device):
        self.data, self.model = data, model
        self.device = torch.device(device)
        self.data_index, self.model_index = divmod(dist.get_rank(), model)
        for mi in range(model):
            group = dist.new_group([di * model + mi for di in range(data)])
            if mi == self.model_index:
                self.data_group = group
        for di in range(data):
            group = dist.new_group([di * model + mi for mi in range(model)])
            if di == self.data_index:
                self.model_group = group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group: a loss's batch sums over the
        whole global batch. Differentiable; the backward is the identity."""
        return _BatchSum.apply(t, self.data_group)

    def _gather(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    def gather_rows(self, shard: torch.Tensor) -> torch.Tensor:
        """The padded table whose rows this rank holds as ``shard``: the
        model group's shards in order."""
        return self._gather(shard, self.model_group, self.model)

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's equal-length ``t`` concatenated in data order."""
        return self._gather(t, self.data_group, self.data)

    def gather_occurrences(self, ids: torch.Tensor, rows: torch.Tensor):
        """The data group's ``(ids [R_i], rows [R_i, D])`` concatenated in
        data order, which is the global batch's order (``put_sharded``
        splits it contiguously): every rank gets every occurrence of the
        step. The slices may differ in length (``tensor_split``), so the
        lengths are gathered first and each slice is padded to the longest
        with ``OCCURRENCE_PAD`` ids and zero rows."""
        lens = self._gather(torch.tensor([ids.shape[0]], device=ids.device),
                            self.data_group, self.data).tolist()
        pad = max(lens) - ids.shape[0]
        if pad:
            ids = torch.cat([ids, ids.new_full((pad,), OCCURRENCE_PAD)])
            rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(rows.shape[1:]))])
        return (self._gather(ids, self.data_group, self.data),
                self._gather(rows, self.data_group, self.data))

    def reduce_gradients(self, params) -> None:
        """Sum every gradient over the data group, in place. Every rank holds
        the gradients of the same parameters (one model, one loss)."""
        for p in params:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=self.data_group)

    def clip_grad_norm_(self, named_params, max_norm: float, sharded) -> torch.Tensor:
        """``torch.nn.utils.clip_grad_norm_`` over the whole parameters: the
        squares of the row-sharded tables (names in ``sharded``) are summed
        over the model group, the replicated ones counted once. Returns the
        total norm."""
        grads = [(n, p.grad) for n, p in named_params if p.grad is not None]
        if not grads:
            return torch.zeros((), device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=grads[0][1].device)
        sq_shard = sum((g.float().pow(2).sum() for n, g in grads if n in sharded), zero)
        sq_rep = sum((g.float().pow(2).sum() for n, g in grads if n not in sharded), zero)
        dist.all_reduce(sq_shard, group=self.model_group)
        total = torch.sqrt(sq_shard + sq_rep)
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for _, g in grads:
            g.mul_(coef.to(g.dtype))
        return total


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None, device="cpu") -> Mesh:
    """The ('data', 'model') mesh over the ranks of the process group.
    Default: every rank on the data axis."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed process group: call "
                           "parallel.distributed.initialize_from_config first")
    n = dist.get_world_size()
    if mesh_shape:
        d = int(mesh_shape.get("data", 1))
        m = int(mesh_shape.get("model", 1))
        if d * m != n:
            raise ValueError(f"mesh_shape {mesh_shape} does not match {n} processes")
    else:
        d, m = n, 1
    return Mesh(d, m, device)


def _is_table(name: str, leaf) -> bool:
    return (
        isinstance(name, str)
        and name.endswith("_embedding")
        and hasattr(leaf, "ndim")
        and leaf.ndim == 2
        and leaf.shape[0] >= MIN_SHARD_ROWS
    )


def param_sharding_rules(params, mesh: Mesh) -> Dict[str, Optional[str]]:
    """``{name: "model" or None}``: embedding tables row-sharded over
    'model' (when it is wider than one), everything else replicated."""
    return {name: "model" if mesh.model > 1 and _is_table(name.rsplit(".", 1)[-1], p) else None
            for name, p in params.items()}


def pad_tables_for_sharding(params, mesh: Mesh):
    """Sharded tables' rows padded with zeros up to a multiple of the 'model'
    axis size; padding rows sit past every real id, so lookups, prefix
    slices and gradients never touch them."""
    rules = param_sharding_rules(params, mesh)
    out = {}
    for name, p in params.items():
        extra = -p.shape[0] % mesh.model if rules[name] else 0
        out[name] = torch.cat([p, p.new_zeros((extra,) + tuple(p.shape[1:]))]) if extra else p
    return out


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every table the rules shard by this rank's rows of it, in
    place, and record the shards in ``module.table_shards`` ({name:
    :class:`TableShard`}) and the mesh in ``module.mesh``. Every rank holds
    the identical full value first (same initialisation seed)."""
    named = dict(module.named_parameters())
    rules = param_sharding_rules(named, mesh)
    padded = pad_tables_for_sharding({n: p.detach() for n, p in named.items()}, mesh)
    module.table_shards = {}
    for name, rule in rules.items():
        if not rule:
            continue
        L = padded[name].shape[0] // mesh.model
        offset = mesh.model_index * L
        owner, _, leaf = name.rpartition(".")
        target = module.get_submodule(owner) if owner else module
        setattr(target, leaf, nn.Parameter(padded[name][offset:offset + L].clone(),
                                           requires_grad=named[name].requires_grad))
        module.table_shards[name] = TableShard(named[name].shape[0], offset)
    module.mesh = mesh
    return module


class ShardedTable:
    """A row-sharded table that indexes like the whole one:
    ``table[ids]`` is the row-sharded lookup."""

    def __init__(self, shard, spec: TableShard, mesh: Mesh):
        self.shard, self.spec, self.mesh = shard, spec, mesh

    def __getitem__(self, ids):
        return sharded_lookup(self.shard, ids, self.spec.offset, self.mesh.model_group)


def make_sharded_train_step(loss_fn, make_optimizer, mesh: Mesh, params):
    """A train step over the mesh for a function-style loss.

    Args:
        loss_fn: ``(tables, batch) -> scalar``, the MEAN loss over the batch
            it is given; ``tables[name][ids]`` reads rows (through the
            row-sharded lookup for a sharded table).
        make_optimizer: ``parameters -> torch.optim.Optimizer``.
        params: ``{name: tensor}``, the full initial values, identical on
            every rank.
    Returns (step, holder, optimizer): ``step(batch) -> loss`` takes the
    GLOBAL host batch (identical on every rank), trains on this rank's data
    slice, weighted by its share of the batch so the summed gradient is the
    global mean's, and returns the global batch's loss; ``holder`` is the
    module holding this rank's parameters (``holder.table_shards`` names the
    sharded ones, see :func:`parallel.distributed.fetch_replicated`).
    """
    holder = nn.Module()
    for name, value in params.items():
        holder.register_parameter(name, nn.Parameter(torch.as_tensor(value).float().clone()))
    shard_params(holder, mesh).to(mesh.device)
    optimizer = make_optimizer(holder.parameters())

    def tables():
        named = dict(holder.named_parameters())
        return {n: ShardedTable(p, holder.table_shards[n], mesh) if n in holder.table_shards
                else p for n, p in named.items()}

    def step(batch):
        local = {k: put_sharded(v, mesh) for k, v in batch.items()}
        n = len(next(iter(batch.values())))
        share = len(next(iter(local.values()))) / n
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(tables(), local) * share
        loss.backward()
        mesh.reduce_gradients(holder.parameters())
        optimizer.step()
        return mesh.batch_sum(loss.detach())

    return step, holder, optimizer

