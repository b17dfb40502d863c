"""K1: pairwise gather-dot score with a row-sum backward.

Port of ``recbole_cdr_tpu/models/cmf.py:45-48 CMF._score`` and its autodiff:
``s[b] = <U[u_b], I[i_b]>``; the backward adds ``g_b * I[i_b]`` into row
``u_b`` of a dense ``dU`` and ``g_b * U[u_b]`` into row ``i_b`` of ``dI``.
The kernels are ``csrc/gather_dot.cu``: a float32 form, and a 16-bit form
(K1-bf16) for the tables of a ``compute_dtype: bfloat16`` step, which loads
the 16-bit rows, multiplies and sums in float32 and writes the score in the
tables' type (JAX's bf16 product, which feeds ``weighted_mean``'s upcast);
its backward sums in float32 and rounds each gradient row once to the
tables' type.

The backward writes each table row once, its pairs' terms added in position
order, so two runs are bit-equal and a row equals the plain version's
``index_add_`` on the CPU. Each table is read in one of two forms
(``groups``): on the card, the step's grouping of its ids by row
(``ops/row_groups.py``; the autograd function builds both tables' in one
launch), or :data:`POSITIONS`, a sub-table whose row r the pairs r, r + N,
r + 2 N, ... read (N its rows): the sparse step's re-based sub-tables and a
mesh lookup's gathered rows, where the caller built the ids so and no
grouping is paid for. The kernel checks every pair's id against that
promise and recomputes a table whose ids break it. The plain versions below
run for CPU tensors and serve as the kernels' reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.row_groups import Groups, RowPlan, group_rows


#: the table types of the kernels and their C type codes: float32, and the
#: 16-bit form (K1-bf16, float16 through the same template) that loads
#: 16-bit rows, multiplies and sums in float32 and rounds the score once to
#: the tables' type
DTYPES = build.DTYPES

#: a table of the backward whose row r the pairs r, r + N, ... read (N its
#: rows, the pairs a multiple of N): no grouping is built for it
POSITIONS = "positions"


def gather_dot_plain(U, I, u, i):
    """The kernels' arithmetic: products and sum in float32, the score in
    the tables' type."""
    return (U[u.long()].float() * I[i.long()].float()).sum(-1).to(U.dtype)


def gather_dot_backward_plain(U, I, u, i, g):
    """Row gradients summed in float32, returned in the tables' type (on the
    CPU, ``index_add_`` adds each row's terms in position order, as every
    form of the kernel does)."""
    u, i, g = u.long(), i.long(), g.float()
    dU = torch.zeros(U.shape, device=U.device).index_add_(0, u, g[:, None] * I[i].float())
    dI = torch.zeros(I.shape, device=I.device).index_add_(0, i, g[:, None] * U[u].float())
    return dU.to(U.dtype), dI.to(I.dtype)


def _check(U, I, u, i, g=None):
    if U.dtype not in DTYPES or I.dtype != U.dtype:
        raise TypeError(f"gather_dot takes two tables of one type of {tuple(DTYPES)}: "
                        f"{U.dtype}, {I.dtype}")
    if U.dim() != 2 or I.dim() != 2 or U.shape[1] != I.shape[1]:
        raise ValueError(f"gather_dot tables must be [N, D] with one D: {U.shape}, {I.shape}")
    if u.dtype != torch.int32 or i.dtype != torch.int32:
        raise TypeError("gather_dot takes int32 ids")
    if u.dim() != 1 or u.shape != i.shape:
        raise ValueError(f"gather_dot ids must be 1-D and aligned: {u.shape}, {i.shape}")
    if len({t.device for t in (U, I, u, i)}) != 1:
        raise ValueError("gather_dot operands must share one device")
    if U.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_dot has no version for device {U.device}")
    if g is not None and (g.dtype != U.dtype or g.shape != u.shape or g.device != U.device):
        raise ValueError("gather_dot backward takes a gradient per pair in the tables' type")


def _vec(D, dtype, *tensors):
    """1 when every row of the tensors starts at a 16-byte load's alignment."""
    return int(D * dtype.itemsize % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _forward(U, I, u, i, name):
    U, I, u, i = (t.contiguous() for t in (U, I, u, i))
    out = torch.empty(u.shape[0], dtype=U.dtype, device=U.device)
    D = U.shape[1]
    err = build.library("gather_dot").gather_dot_forward(
        U.data_ptr(), I.data_ptr(), u.data_ptr(), i.data_ptr(), out.data_ptr(),
        u.shape[0], D, DTYPES[U.dtype], _vec(D, U.dtype, U, I), build.stream_handle(U),
    )
    build.check(err, name)
    return out


#: per device, the positions form's check flag, count of finished blocks
#: and count of rescans (a table whose ids broke the promise, recomputed)
_GUARDS = {}


def positions_rescans(device) -> int:
    """How many positions-form tables on the CUDA ``device`` the backward
    has had to recompute because their ids broke the promise (0 on a
    correct path); reading it waits for the device."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    guard = _GUARDS.get(device)
    return 0 if guard is None else int(guard[2])


def _side(table, ids, side, name):
    """(positions flag, its plan's C array or None) of one table's form."""
    N, P = table.shape[0], ids.shape[0]
    if side == POSITIONS:
        if N == 0 or P % N:
            raise ValueError(f"{name}: {P} pairs do not read a {N}-row table by positions")
        return 1, None
    if not isinstance(side, Groups) or side.R != P or side.L != N or side.offset != 0 \
            or side.meta.device != table.device:
        raise ValueError(f"{name}: a table of {N} rows needs POSITIONS or the grouping of its "
                         f"{P} ids over its rows")
    return 0, side.pointers()


def _backward(U, I, u, i, g, groups, name):
    """Every row of both tables written once, in the tables' type."""
    U, I, u, i, g = (t.contiguous() for t in (U, I, u, i, g))
    (pu, plan_u), (pi, plan_i) = (_side(t, ids, s, name)
                                  for t, ids, s in ((U, u, groups[0]), (I, i, groups[1])))
    dU, dI = torch.empty_like(U), torch.empty_like(I)
    guard = _GUARDS.get(U.device)
    if guard is None:
        guard = _GUARDS[U.device] = torch.zeros(3, dtype=torch.int32, device=U.device)
    D = U.shape[1]
    err = build.library("gather_dot").gather_dot_backward(
        U.data_ptr(), I.data_ptr(), u.data_ptr(), i.data_ptr(), g.data_ptr(), u.shape[0], D,
        U.shape[0], pu, plan_u, I.shape[0], pi, plan_i, dU.data_ptr(), dI.data_ptr(),
        guard.data_ptr(), DTYPES[U.dtype], _vec(D, U.dtype, U, I, dU, dI),
        build.stream_handle(U),
    )
    build.check(err, name)
    return dU, dI


def gather_dot_forward(U, I, u, i):
    """Scores ``(U[u] * I[i]).sum(-1)`` in the tables' type; 16-bit tables
    go to :func:`gather_dot_forward_bf16`."""
    _check(U, I, u, i)
    if U.device.type == "cpu":
        return gather_dot_plain(U, I, u, i)
    if U.dtype != torch.float32:
        return gather_dot_forward_bf16(U, I, u, i)
    out = _forward(U, I, u, i, "gather_dot_forward")
    gather_dot_forward.launches += 1
    return out


gather_dot_forward.launches = 0


def gather_dot_forward_bf16(U, I, u, i):
    """K1's 16-bit form: bfloat16 (or float16) tables, float32 products and
    sum, the score rounded once to the tables' type."""
    _check(U, I, u, i)
    if U.dtype == torch.float32:
        raise TypeError("gather_dot_forward_bf16 takes 16-bit tables")
    if U.device.type == "cpu":
        return gather_dot_plain(U, I, u, i)
    out = _forward(U, I, u, i, "gather_dot_forward_bf16")
    gather_dot_forward_bf16.launches += 1
    return out


gather_dot_forward_bf16.launches = 0


def gather_dot_backward(U, I, u, i, g, groups):
    """(dU, dI) in the tables' type; 16-bit tables go to
    :func:`gather_dot_backward_bf16`. ``groups``: per table,
    :data:`POSITIONS` or, on the card, the :class:`Groups` of its ids over
    its rows (the plain version on the CPU reads no grouping)."""
    _check(U, I, u, i, g)
    if U.device.type == "cpu":
        return gather_dot_backward_plain(U, I, u, i, g)
    if U.dtype != torch.float32:
        return gather_dot_backward_bf16(U, I, u, i, g, groups)
    out = _backward(U, I, u, i, g, groups, "gather_dot_backward")
    gather_dot_backward.launches += 1
    return out


gather_dot_backward.launches = 0


def gather_dot_backward_bf16(U, I, u, i, g, groups):
    """K1's 16-bit backward: each row's float32 sum rounded once to the
    tables' type as it is written."""
    _check(U, I, u, i, g)
    if U.dtype == torch.float32:
        raise TypeError("gather_dot_backward_bf16 takes 16-bit tables")
    if U.device.type == "cpu":
        return gather_dot_backward_plain(U, I, u, i, g)
    out = _backward(U, I, u, i, g, groups, "gather_dot_backward_bf16")
    gather_dot_backward_bf16.launches += 1
    return out


gather_dot_backward_bf16.launches = 0


#: per (device, rows, table slot), the kept plan of the autograd backward's
#: groupings
_PLANS = {}


def backward_groups(U, I, u, i, positions=(False, False)):
    """Both tables' forms for :func:`gather_dot_backward`: :data:`POSITIONS`
    where ``positions`` marks the table and the pairs are a multiple of its
    rows; else, on the card, the grouping of its ids (both tables' built in
    one launch), and None on the CPU."""
    sides, need = [], []
    for k, (table, ids) in enumerate(((U, u), (I, i))):
        N = table.shape[0]
        if positions[k] and N and ids.shape[0] % N == 0:
            sides.append(POSITIONS)
            continue
        sides.append(None)
        if table.device.type == "cuda":
            key = (table.device, N, k)
            plan = _PLANS.get(key)
            if plan is None:
                plan = _PLANS[key] = RowPlan(N, table.device, capacity=ids.shape[0])
            need.append((k, (ids, plan)))
    if need:
        built = group_rows(*need[0][1], second=need[1][1] if len(need) > 1 else None)
        for (k, _), grp in zip(need, built if len(need) > 1 else (built,)):
            sides[k] = grp
    return tuple(sides)


class _GatherDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, I, u, i, positions):
        ctx.save_for_backward(U, I, u, i)
        ctx.positions = positions
        return gather_dot_forward(U, I, u, i)

    @staticmethod
    def backward(ctx, g):
        U, I, u, i = ctx.saved_tensors
        dU, dI = gather_dot_backward(U, I, u, i, g.contiguous(),
                                     backward_groups(U, I, u, i, ctx.positions))
        return dU, dI, None, None, None


def gather_dot(U, I, u, i, positions=(False, False)):
    """Differentiable ``(U[u] * I[i]).sum(-1)`` for int32 ids ``u``, ``i``
    and float32, bfloat16 or float16 tables. ``positions``: per table,
    whether it is a sub-table whose row r the pairs r, r + N, ... read (the
    caller built the ids so; the backward then builds no grouping for it)."""
    return _GatherDot.apply(U, I, u, i, tuple(positions))
