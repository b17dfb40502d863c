"""B6: SparseAdam row update of one embedding table.

Port of ``recbole_cdr_tpu/trainer/trainer.py:274-311 SparseAdam.row_update``
(torch.optim.SparseAdam semantics): ``g_rows[j]`` is the gradient of row
``ids[j]``; duplicate ids are coalesced by summation into the slot of their
first occurrence, and each touched row takes one lazy Adam step with
``denom = sqrt(nu) + eps`` and both bias corrections folded into
``step_size`` (:func:`adam_step_size`). ``p``, ``mu`` and ``nu`` are updated
in place; untouched rows are neither read nor written.

Row-shard form (``row_offset``): under a mesh whose ``model`` axis shards the
table, ``p``, ``mu`` and ``nu`` are this rank's rows ``[row_offset,
row_offset + L)`` and ``ids`` the GLOBAL rows of every occurrence of the step
(every data rank's, ``parallel/mesh.py::Mesh.gather_occurrences``); an
occurrence outside the shard, padding included, is skipped, so duplicates
coalesce into their first occurrence in the global order, as JAX's
``row_update`` does on the whole table, and each rank updates only its own
rows. ``row_offset`` 0 with ``L`` = N is the whole table.

The kernel is ``csrc/sparse_adam.cu``: one launch over the step's grouping
of the ids by row (``ops/row_groups.py``, built by the caller over the
shard's rows), each touched row's gradient rows added in position order,
then its Adam step; the plain version below runs for CPU tensors and serves
as the kernel's reference.
"""

import numpy as np
import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.row_groups import Groups

INT32_MAX = 2 ** 31 - 1


def adam_step_size(lr: float, b1: float, b2: float, count: int) -> float:
    """``lr * sqrt(1 - b2^c) / (1 - b1^c)`` in float32, the order and type of
    the JAX package (``cf = c.astype(float32)``)."""
    f = np.float32
    cf = f(count)
    bc1 = f(1.0) - f(b1) ** cf
    bc2 = f(1.0) - f(b2) ** cf
    return float(f(lr) * np.sqrt(bc2) / bc1)


def sparse_adam_plain(p, mu, nu, g_rows, ids, step_size: float, b1: float, b2: float,
                      eps: float, row_offset: int = 0):
    """The kernel's arithmetic: each touched row's gradient rows added in
    position order into the slot of its first occurrence (the order of the
    kernel's grouping), then its Adam step."""
    L = p.shape[0]
    local = ids.long() - row_offset
    own = (local >= 0) & (local < L)  # the shard's occurrences, in their order
    ids64, g_rows = local[own], g_rows[own]
    R = ids64.shape[0]
    pos = torch.arange(R, device=p.device)
    firstpos = torch.full((L,), R, dtype=torch.int64, device=p.device)
    firstpos.scatter_reduce_(0, ids64, pos, "amin")
    fp = firstpos[ids64]
    head = fp == pos
    gc = torch.zeros_like(g_rows).index_add_(0, fp, g_rows)[head]
    rows = ids64[head]
    m = b1 * mu[rows] + (1.0 - b1) * gc
    v = b2 * nu[rows] + (1.0 - b2) * gc * gc
    # the correctly rounded float32 square root (as the kernel's and CUDA's):
    # the CPU's float32 torch.sqrt is not, so it is taken in float64
    upd = (-step_size) * m / (torch.sqrt(v.double()).to(v.dtype) + eps)
    p.index_copy_(0, rows, p[rows] + upd)
    mu.index_copy_(0, rows, m)
    nu.index_copy_(0, rows, v)


def sparse_adam(p, mu, nu, g_rows, ids, step_size: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, groups=None, row_offset: int = 0):
    """One SparseAdam step of table ``p`` [L, D], global rows ``[row_offset,
    row_offset + L)`` (and its moments ``mu``, ``nu``), in place, from
    gradient rows ``g_rows`` [R, D] of global rows ``ids`` [R] int32
    (duplicates allowed; ids outside the shard are skipped). ``groups``: the
    grouping of ``ids`` over the shard's rows (``ops/row_groups.py::
    group_rows`` with the table's kept scratch), which the card needs; the
    plain version on the CPU reads the ids instead)."""
    if any(t.dtype != torch.float32 for t in (p, mu, nu, g_rows)):
        raise TypeError("sparse_adam takes float32 tables, moments and gradients")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError("sparse_adam takes int32 [R] ids")
    if p.dim() != 2 or mu.shape != p.shape or nu.shape != p.shape:
        raise ValueError(f"sparse_adam: p {p.shape}, mu {mu.shape}, nu {nu.shape}")
    if g_rows.shape != (ids.shape[0], p.shape[1]):
        raise ValueError(f"sparse_adam: g_rows {g_rows.shape} for {ids.shape[0]} ids")
    if len({t.device for t in (p, mu, nu, g_rows, ids)}) != 1:
        raise ValueError("sparse_adam operands must share one device")
    if not 0 <= row_offset <= INT32_MAX - p.shape[0]:
        raise ValueError(f"sparse_adam: row_offset {row_offset} for {p.shape[0]} rows")
    if groups is not None and (not isinstance(groups, Groups) or groups.R != ids.shape[0]
                               or groups.L != p.shape[0] or groups.offset != row_offset
                               or groups.meta.device != p.device):
        raise ValueError("sparse_adam: groups must be the grouping of the ids over the "
                         "shard's rows")
    if p.device.type == "cpu":
        return sparse_adam_plain(p, mu, nu, g_rows, ids, step_size, b1, b2, eps, row_offset)
    if p.device.type != "cuda":
        raise ValueError(f"sparse_adam has no version for device {p.device}")
    if not all(t.is_contiguous() for t in (p, mu, nu)):
        raise ValueError("sparse_adam updates p, mu and nu in place: they must be contiguous")
    if groups is None:
        raise ValueError("sparse_adam on the card takes the grouping of its ids")
    g_rows = g_rows.contiguous()
    D = p.shape[1]
    vec = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (p, mu, nu, g_rows)))
    f = np.float32
    err = build.library("sparse_adam").sparse_adam(
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g_rows.data_ptr(), ids.shape[0], D,
        groups.pointers(), float(f(step_size)), float(f(b1)), float(f(1.0 - b1)), float(f(b2)),
        float(f(1.0 - b2)), float(f(eps)), vec, build.stream_handle(p),
    )
    build.check(err, "sparse_adam")
    sparse_adam.launches += 1


sparse_adam.launches = 0
