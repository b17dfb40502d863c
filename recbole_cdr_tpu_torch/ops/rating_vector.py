"""B11: DTCDR's DMF rating-vector product, forward and backward.

Port of ``recbole_cdr_tpu/models/dtcdr.py:127-154``: ``_rating_vector``
scatters each id's padded history row into a dense binary [B, N] vector
(duplicates count once, column 0 is PAD and zeroed), which DMF then
multiplies by an [N, D] table, four times per logit. The vector is a set, so
with the history held as a CSR of each row's distinct non-PAD entries
(:func:`history_csr`) the same function is a gather-sum,
``out[b] = sum over j in row(ids[b]) of table[cols[j]]``, and its gradient
``dtable[c]`` the sum of ``gout[b]`` over the ids whose rows hold ``c``;
neither direction builds the [B, N] vector (0.9 GB per call at the smoke
pair's shapes).

Under ``compute_dtype: bfloat16`` the table is a 16-bit copy while JAX's
rating vector stays float32, and ``float32 @ bf16`` promotes to float32:
the 16-bit form (B11-bf16, float16 through the same template) reads 16-bit
rows, sums them in float32 and returns float32, and the table's gradient is
the float32 row sum rounded once to the table's type (the promotion's
cast).

The kernels are ``csrc/rating_vector.cu``. Every float sum there runs in an
order fixed by the inputs, so two runs are bit-equal. They work per distinct
id of a batch, from the ids' grouping by history row
(:class:`~recbole_cdr_tpu_torch.ops.row_groups.Groups`, made by
:func:`~recbole_cdr_tpu_torch.ops.row_groups.group_rows` on a ``RowPlan``
over the history's rows; DMF groups both sides' ids in one launch a step)
and shared by every table and direction that takes those ids; the backward
walks the transposed history, and rows longer than ``PIECE`` entries are cut
into static pieces, both built once per history on the host
(:func:`history_layout`). The plain versions below, an ``index_add_`` over
the gathered [nnz, D] rows, run for CPU tensors (they read the ids, not the
grouping) and serve as the kernels' reference.
"""

from typing import NamedTuple

import numpy as np
import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.row_groups import Groups

DTYPES = build.DTYPES
#: history entries of a static piece: a row with more is summed piece by
#: piece, and the pieces' partial sums are added in piece order
PIECE = 64
#: pieces of a row whose partial sums a block adds (a warp adds fewer)
BIG_PIECES = 32


class HistoryLayout(NamedTuple):
    """The kernels' static view of a history of R rows over N table rows
    (:func:`history_layout`), int32 tensors: the rows of more than
    ``PIECE`` entries cut into pieces (piece p of row ``p_row[p]``, row r's
    pieces ``p_first[r]`` .. ``p_first[r + 1]``; the rows of more than
    ``BIG_PIECES`` pieces ``p_big``, the other cut rows ``p_small``); the
    transposed history (``tcols[tptr[c]:tptr[c + 1]]`` the
    rows that hold table row c, increasing) and its long rows' pieces the
    same way."""
    p_row: torch.Tensor
    p_first: torch.Tensor
    p_big: torch.Tensor
    p_small: torch.Tensor
    tptr: torch.Tensor
    tcols: torch.Tensor
    tp_row: torch.Tensor
    tp_first: torch.Tensor
    tp_big: torch.Tensor
    tp_small: torch.Tensor


class HistoryCSR(NamedTuple):
    """Per row, its distinct non-PAD entries, sorted: ``cols[ptr[r]:ptr[r + 1]]``
    (int32 ``ptr`` [R + 1], int32 ``cols`` [nnz]), and the kernels' layout
    of it, built with it once (:func:`history_tensors`)."""
    ptr: torch.Tensor
    cols: torch.Tensor
    layout: HistoryLayout


def history_csr(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """(ptr, cols) int32 numpy arrays of the distinct non-PAD (column 0)
    entries of each row in ``[0, n_rows)``, from aligned interaction arrays."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = cols != 0
    n_cols = int(cols.max()) + 1 if len(cols) else 1
    keys = np.unique(rows[keep] * n_cols + cols[keep])
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys // n_cols, minlength=n_rows), out=ptr[1:])
    return ptr.astype(np.int32), (keys % n_cols).astype(np.int32)


def transpose_history(ptr: np.ndarray, cols: np.ndarray, n_cols: int):
    """(tptr [n_cols + 1], tcols) int32: for every table row c, the history
    rows that hold it, in increasing order."""
    ptr = np.asarray(ptr, np.int64)
    cols = np.asarray(cols, np.int64)
    rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    order = np.argsort(cols, kind="stable")  # rows stay increasing within a column
    tptr = np.zeros(n_cols + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=n_cols), out=tptr[1:])
    return tptr.astype(np.int32), rows[order].astype(np.int32)


def long_pieces(ptr: np.ndarray):
    """(row, first, big, small) int32: the rows of more than ``PIECE``
    entries cut into pieces of ``PIECE`` (piece p of row ``row[p]``, row r's
    pieces ``first[r]`` .. ``first[r + 1]``), those of more than
    ``BIG_PIECES`` pieces, and the others."""
    lens = np.diff(np.asarray(ptr, np.int64))
    n = np.where(lens > PIECE, -(-lens // PIECE), 0)
    first = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(n, out=first[1:])
    return (np.repeat(np.arange(len(lens)), n).astype(np.int32), first.astype(np.int32),
            np.flatnonzero(n > BIG_PIECES).astype(np.int32),
            np.flatnonzero((n > 0) & (n <= BIG_PIECES)).astype(np.int32))


def history_layout(ptr: np.ndarray, cols: np.ndarray, n_cols: int) -> HistoryLayout:
    """The :class:`HistoryLayout` (of numpy int32 arrays) of a history over
    ``n_cols`` table rows."""
    tptr, tcols = transpose_history(ptr, cols, n_cols)
    return HistoryLayout(*long_pieces(ptr), tptr, tcols, *long_pieces(tptr))


def history_tensors(ptr: np.ndarray, cols: np.ndarray, n_cols: int, device=None) -> HistoryCSR:
    """The :class:`HistoryCSR` of a :func:`history_csr` (``ptr``, ``cols``)
    over ``n_cols`` table rows, with its layout, as tensors on ``device``."""
    def tensor(a):
        return torch.as_tensor(a, device=device)

    return HistoryCSR(tensor(ptr), tensor(cols),
                      HistoryLayout(*map(tensor, history_layout(ptr, cols, n_cols))))


def _expand(csr: HistoryCSR, ids):
    """(owner, entry) of every history entry of every id: the id's position
    and the entry's index into ``csr.cols``."""
    ids = ids.long()
    lo = csr.ptr[ids].long()
    counts = csr.ptr[ids + 1].long() - lo
    owner = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device), counts)
    first = torch.cumsum(counts, 0) - counts
    entry = torch.arange(owner.shape[0], device=ids.device) - first[owner] + lo[owner]
    return owner, entry


def rating_vector_plain(csr: HistoryCSR, table, ids):
    """float32 [B, D]: the table's rows widened to float32 and summed."""
    owner, entry = _expand(csr, ids)
    out = torch.zeros(ids.shape[0], table.shape[1], dtype=torch.float32, device=table.device)
    return out.index_add_(0, owner, table[csr.cols[entry].long()].float())


def rating_vector_backward_plain(csr: HistoryCSR, n_rows: int, ids, gout,
                                 dtype=torch.float32):
    """The float32 gradient sums, rounded once to ``dtype`` (the table's)."""
    owner, entry = _expand(csr, ids)
    dtable = torch.zeros(n_rows, gout.shape[1], dtype=gout.dtype, device=gout.device)
    return dtable.index_add_(0, csr.cols[entry].long(), gout[owner]).to(dtype)


def _check_ids(ids, what):
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{what} takes 1-D int32 ids")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no version for device {ids.device}")


def _check(csr: HistoryCSR, ids, dense, what, types=(torch.float32,)):
    if csr.ptr.dtype != torch.int32 or csr.cols.dtype != torch.int32:
        raise TypeError(f"{what} takes an int32 CSR")
    _check_ids(ids, what)
    if csr.ptr.dim() != 1 or csr.cols.dim() != 1:
        raise ValueError(f"{what}: ptr and cols must be 1-D")
    if dense.dtype not in types or dense.dim() != 2:
        raise TypeError(f"{what} takes a [rows, D] operand of a type of {types}, "
                        f"got {dense.dtype}")
    if len({t.device for t in (csr.ptr, csr.cols, ids, dense)}) != 1:
        raise ValueError(f"{what} operands must share one device")
    if dense.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no version for device {dense.device}")


def _check_groups(csr: HistoryCSR, ids, groups, what):
    """The grouping must be of these ids over the history's rows from 0."""
    if not isinstance(groups, Groups):
        raise TypeError(f"{what} takes the ids' Groups (ops.row_groups.group_rows), "
                        f"got {type(groups).__name__}")
    R = csr.ptr.shape[0] - 1
    if groups.R != ids.shape[0] or groups.L != R or groups.offset != 0:
        raise ValueError(f"{what}: a grouping of {groups.R} ids over rows [{groups.offset}, "
                         f"{groups.offset + groups.L}) for {ids.shape[0]} ids over [0, {R})")
    if groups.meta.device != ids.device:
        raise ValueError(f"{what}: a grouping on {groups.meta.device} for ids on {ids.device}")


def _kernel_args(csr: HistoryCSR, n_cols: int):
    """(the CSR contiguous, its layout) for a launch, once the layout is
    checked against the history."""
    layout = csr.layout
    R = csr.ptr.shape[0] - 1
    if layout.p_first.shape[0] != R + 1 or layout.tptr.shape[0] != n_cols + 1:
        raise ValueError(f"a layout of {layout.p_first.shape[0] - 1} rows over "
                         f"{layout.tptr.shape[0] - 1} table rows for a history of {R} over "
                         f"{n_cols}")
    return HistoryCSR(csr.ptr.contiguous(), csr.cols.contiguous(), layout), layout


def _vec(D: int, *tensors) -> int:
    """4 when every row of the tensors starts at a 4-value load's alignment."""
    ok = D % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return 4 if ok else 1


def _forward(csr: HistoryCSR, table, ids, groups, name):
    table, ids = table.contiguous(), ids.contiguous()
    csr, lay = _kernel_args(csr, table.shape[0])
    B, D = ids.shape[0], table.shape[1]
    n_pieces = lay.p_row.shape[0]
    part = torch.empty(max(n_pieces, 1), D, dtype=torch.float32, device=table.device)
    out = torch.empty(B, D, dtype=torch.float32, device=table.device)
    err = build.library("rating_vector").rating_vector_forward(
        csr.ptr.data_ptr(), csr.cols.data_ptr(), csr.ptr.shape[0] - 1, lay.p_row.data_ptr(),
        lay.p_first.data_ptr(), n_pieces, lay.p_big.data_ptr(), lay.p_big.shape[0],
        lay.p_small.data_ptr(), lay.p_small.shape[0], PIECE,
        table.data_ptr(), D, DTYPES[table.dtype], _vec(D, table, out), ids.data_ptr(), B,
        groups.pointers(), part.data_ptr(), out.data_ptr(), build.stream_handle(table),
    )
    build.check(err, name)
    return out


def _backward(csr: HistoryCSR, n_rows: int, ids, gout, dtype, groups, name):
    """Every table row is written once: the float32 sum over the transposed
    history, rounded once to a 16-bit ``dtype``."""
    gout = gout.contiguous()
    csr, lay = _kernel_args(csr, n_rows)
    B, D = ids.shape[0], gout.shape[1]
    n_pieces = lay.tp_row.shape[0]
    gsum = torch.empty(max(B, 1), D, dtype=torch.float32, device=gout.device)
    part = torch.empty(max(n_pieces, 1), D, dtype=torch.float32, device=gout.device)
    out = torch.empty(n_rows, D, dtype=dtype, device=gout.device)
    err = build.library("rating_vector").rating_vector_backward(
        lay.tptr.data_ptr(), lay.tcols.data_ptr(), n_rows, lay.tp_row.data_ptr(),
        lay.tp_first.data_ptr(), n_pieces, lay.tp_big.data_ptr(), lay.tp_big.shape[0],
        lay.tp_small.data_ptr(), lay.tp_small.shape[0], PIECE,
        gout.data_ptr(), D, _vec(D, gout, out), groups.pointers(), gsum.data_ptr(),
        part.data_ptr(), DTYPES[dtype], out.data_ptr(), build.stream_handle(gout),
    )
    build.check(err, name)
    return out


def rating_vector_forward(csr: HistoryCSR, table, ids, groups: Groups):
    """float32 [B, D]: the sum of ``table``'s rows at each id's history; a
    16-bit table goes to :func:`rating_vector_forward_bf16`. ``groups``: the
    ids' grouping over the history's rows (``group_rows`` on a ``RowPlan``
    of them; checked on every device, read by the kernels alone)."""
    _check(csr, ids, table, "rating_vector_forward", tuple(DTYPES))
    _check_groups(csr, ids, groups, "rating_vector_forward")
    if table.device.type == "cpu":
        return rating_vector_plain(csr, table, ids)
    if table.dtype != torch.float32:
        return rating_vector_forward_bf16(csr, table, ids, groups)
    out = _forward(csr, table, ids, groups, "rating_vector_forward")
    rating_vector_forward.launches += 1
    return out


rating_vector_forward.launches = 0


def rating_vector_forward_bf16(csr: HistoryCSR, table, ids, groups: Groups):
    """B11's 16-bit form: a bfloat16 (or float16) table's rows at each id's
    history, widened and summed in float32, float32 [B, D]."""
    _check(csr, ids, table, "rating_vector_forward_bf16", build.FLOAT16)
    _check_groups(csr, ids, groups, "rating_vector_forward_bf16")
    if table.device.type == "cpu":
        return rating_vector_plain(csr, table, ids)
    out = _forward(csr, table, ids, groups, "rating_vector_forward_bf16")
    rating_vector_forward_bf16.launches += 1
    return out


rating_vector_forward_bf16.launches = 0


def _check_backward(ids, gout, dtype, what):
    if gout.shape[0] != ids.shape[0]:
        raise ValueError(f"{what}: gout {tuple(gout.shape)} for {ids.shape[0]} ids")
    if dtype not in DTYPES:
        raise TypeError(f"{what}: no table type {dtype}")


def rating_vector_backward(csr: HistoryCSR, n_rows: int, ids, gout, dtype, groups: Groups):
    """[n_rows, D] of the table's type ``dtype``: for each table row, the
    sum of ``gout[b]`` (float32) over the ids whose history holds it; a
    16-bit ``dtype`` goes to :func:`rating_vector_backward_bf16`."""
    _check(csr, ids, gout, "rating_vector_backward")
    _check_backward(ids, gout, dtype, "rating_vector_backward")
    _check_groups(csr, ids, groups, "rating_vector_backward")
    if gout.device.type == "cpu":
        return rating_vector_backward_plain(csr, n_rows, ids, gout, dtype)
    if dtype != torch.float32:
        return rating_vector_backward_bf16(csr, n_rows, ids, gout, dtype, groups)
    out = _backward(csr, n_rows, ids, gout, dtype, groups, "rating_vector_backward")
    rating_vector_backward.launches += 1
    return out


rating_vector_backward.launches = 0


def rating_vector_backward_bf16(csr: HistoryCSR, n_rows: int, ids, gout, dtype, groups: Groups):
    """B11's 16-bit backward: each table row's float32 gradient sum rounded
    once to ``dtype`` (bfloat16 or float16) as it is written."""
    _check(csr, ids, gout, "rating_vector_backward_bf16")
    _check_backward(ids, gout, dtype, "rating_vector_backward_bf16")
    _check_groups(csr, ids, groups, "rating_vector_backward_bf16")
    if dtype == torch.float32:
        raise TypeError("rating_vector_backward_bf16 returns a 16-bit gradient")
    if gout.device.type == "cpu":
        return rating_vector_backward_plain(csr, n_rows, ids, gout, dtype)
    out = _backward(csr, n_rows, ids, gout, dtype, groups, "rating_vector_backward_bf16")
    rating_vector_backward_bf16.launches += 1
    return out


rating_vector_backward_bf16.launches = 0


class _RatingVector(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, csr, ids, groups):
        ctx.csr, ctx.ids, ctx.groups = csr, ids, groups
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        return rating_vector_forward(csr, table, ids, groups)

    @staticmethod
    def backward(ctx, g):
        return (rating_vector_backward(ctx.csr, ctx.n_rows, ctx.ids, g.contiguous(), ctx.dtype,
                                       ctx.groups),
                None, None, None)


def rating_vector(csr: HistoryCSR, table, ids, groups: Groups):
    """Differentiable (in ``table``) ``_rating_vector(history, ids, N) @ table``
    for int32 ``ids``: the sum of ``table``'s rows at each id's history,
    float32 for a float32, bfloat16 or float16 table. The forward and the
    backward both read ``groups``, the ids' grouping over the history's rows
    (``group_rows`` on a ``RowPlan`` of them); on the card it is the plan's
    own object, so no other ``group_rows`` call on that plan may come
    between the forward and the backward."""
    return _RatingVector.apply(table, csr, ids, groups)
