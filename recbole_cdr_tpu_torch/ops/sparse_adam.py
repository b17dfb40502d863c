"""B6: SparseAdam row update of one embedding table.

Port of ``recbole_cdr_tpu/trainer/trainer.py:274-311 SparseAdam.row_update``
(torch.optim.SparseAdam semantics): ``g_rows[j]`` is the gradient of row
``ids[j]``; duplicate ids are coalesced by summation into the slot of their
first occurrence, and each touched row takes one lazy Adam step with
``denom = sqrt(nu) + eps`` and both bias corrections folded into
``step_size`` (:func:`adam_step_size`). ``p``, ``mu`` and ``nu`` are updated
in place; untouched rows are neither read nor written.

The kernel is ``csrc/sparse_adam.cu``; the plain version below runs for CPU
tensors and serves as the kernel's reference.
"""

import numpy as np
import torch

from recbole_cdr_tpu_torch.ops import build

INT32_MAX = 2 ** 31 - 1


def adam_step_size(lr: float, b1: float, b2: float, count: int) -> float:
    """``lr * sqrt(1 - b2^c) / (1 - b1^c)`` in float32, the order and type of
    the JAX package (``cf = c.astype(float32)``)."""
    f = np.float32
    cf = f(count)
    bc1 = f(1.0) - f(b1) ** cf
    bc2 = f(1.0) - f(b2) ** cf
    return float(f(lr) * np.sqrt(bc2) / bc1)


def first_position_scratch(n_rows: int, device) -> torch.Tensor:
    """The kernel's [N] int32 first-occurrence scratch, filled with INT32_MAX
    once; every kernel call leaves it so."""
    return torch.full((n_rows,), INT32_MAX, dtype=torch.int32, device=device)


def sparse_adam_plain(p, mu, nu, g_rows, ids, step_size: float, b1: float, b2: float,
                      eps: float):
    N, R = p.shape[0], ids.shape[0]
    pos = torch.arange(R, device=p.device)
    ids64 = ids.long()
    firstpos = torch.full((N,), R, dtype=torch.int64, device=p.device)
    firstpos.scatter_reduce_(0, ids64, pos, "amin")
    fp = firstpos[ids64]
    head = fp == pos
    gc = torch.zeros_like(g_rows).index_add_(0, fp, g_rows)[head]
    rows = ids64[head]
    m = b1 * mu[rows] + (1.0 - b1) * gc
    v = b2 * nu[rows] + (1.0 - b2) * gc * gc
    upd = (-step_size) * m / (torch.sqrt(v) + eps)
    p.index_copy_(0, rows, p[rows] + upd)
    mu.index_copy_(0, rows, m)
    nu.index_copy_(0, rows, v)


def sparse_adam(p, mu, nu, g_rows, ids, step_size: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, firstpos=None):
    """One SparseAdam step of table ``p`` [N, D] (and its moments ``mu``,
    ``nu``) in place, from gradient rows ``g_rows`` [R, D] of rows ``ids``
    [R] int32 (in [0, N), duplicates allowed). On the card, ``firstpos`` is
    the table's scratch from :func:`first_position_scratch`, kept by the
    caller across steps so that a step costs O(R), not O(N)."""
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
    if p.device.type == "cpu":
        return sparse_adam_plain(p, mu, nu, g_rows, ids, step_size, b1, b2, eps)
    if p.device.type != "cuda":
        raise ValueError(f"sparse_adam has no version for device {p.device}")
    if not all(t.is_contiguous() for t in (p, mu, nu)):
        raise ValueError("sparse_adam updates p, mu and nu in place: they must be contiguous")
    if firstpos is None or firstpos.dtype != torch.int32 \
            or firstpos.shape != (p.shape[0],) or firstpos.device != p.device:
        raise ValueError("sparse_adam: firstpos must be the table's int32 [N] scratch")
    g_rows, ids = g_rows.contiguous(), ids.contiguous()
    acc = torch.zeros_like(g_rows)
    f = np.float32
    err = build.library("sparse_adam").sparse_adam(
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g_rows.data_ptr(), ids.data_ptr(),
        firstpos.data_ptr(), acc.data_ptr(), ids.shape[0], p.shape[1],
        float(f(step_size)), float(f(b1)), float(f(1.0 - b1)), float(f(b2)),
        float(f(1.0 - b2)), float(f(eps)), build.stream_handle(p),
    )
    build.check(err, "sparse_adam")
    sparse_adam.launches += 1


sparse_adam.launches = 0
