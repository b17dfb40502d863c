"""B11: DTCDR's DMF rating-vector product, forward and backward.

Port of ``recbole_cdr_tpu/models/dtcdr.py:127-154``: ``_rating_vector``
scatters each id's padded history row into a dense binary [B, N] vector
(duplicates count once, column 0 is PAD and zeroed), which DMF then
multiplies by an [N, D] table, four times per logit. The vector is a set, so
with the history held as a CSR of each row's distinct non-PAD entries
(:func:`history_csr`) the same function is a gather-sum,
``out[b] = sum over j in row(ids[b]) of table[cols[j]]``, and its gradient a
scatter-add of ``gout[b]`` into those rows; neither direction builds the
[B, N] vector (0.9 GB per call at the smoke pair's shapes).

The kernels are ``csrc/rating_vector.cu`` (one distinct id's row summed
once per launch, in pieces of 32 entries); the plain versions below, an
``index_add_`` over the gathered [nnz, D] rows, run for CPU tensors and
serve as the kernels' reference.
"""

from typing import NamedTuple

import numpy as np
import torch

from recbole_cdr_tpu_torch.ops import build

INT32_MAX = 2 ** 31 - 1


class HistoryCSR(NamedTuple):
    """Per row, its distinct non-PAD entries, sorted: ``cols[ptr[r]:ptr[r + 1]]``
    (int32 ``ptr`` [R + 1], int32 ``cols`` [nnz])."""
    ptr: torch.Tensor
    cols: torch.Tensor


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
    owner, entry = _expand(csr, ids)
    out = torch.zeros(ids.shape[0], table.shape[1], dtype=table.dtype, device=table.device)
    return out.index_add_(0, owner, table[csr.cols[entry].long()])


def rating_vector_backward_plain(csr: HistoryCSR, n_rows: int, ids, gout):
    owner, entry = _expand(csr, ids)
    dtable = torch.zeros(n_rows, gout.shape[1], dtype=gout.dtype, device=gout.device)
    return dtable.index_add_(0, csr.cols[entry].long(), gout[owner])


def _check(csr: HistoryCSR, ids, dense, what):
    if csr.ptr.dtype != torch.int32 or csr.cols.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError(f"{what} takes an int32 CSR and int32 ids")
    if csr.ptr.dim() != 1 or csr.cols.dim() != 1 or ids.dim() != 1:
        raise ValueError(f"{what}: ptr, cols and ids must be 1-D")
    if dense.dtype != torch.float32 or dense.dim() != 2:
        raise TypeError(f"{what} takes a float32 [rows, D] operand")
    if len({t.device for t in (csr.ptr, csr.cols, ids, dense)}) != 1:
        raise ValueError(f"{what} operands must share one device")
    if dense.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no version for device {dense.device}")


def _scratch(csr: HistoryCSR, B: int, device):
    """(firstpos [R] at INT32_MAX, head_of [B], piece_start [B + 1])."""
    return (torch.full((csr.ptr.shape[0] - 1,), INT32_MAX, dtype=torch.int32, device=device),
            torch.empty(B, dtype=torch.int32, device=device),
            torch.empty(B + 1, dtype=torch.int32, device=device))


def rating_vector_forward(csr: HistoryCSR, table, ids):
    """float32 [B, D]: the sum of ``table``'s rows at each id's history."""
    _check(csr, ids, table, "rating_vector_forward")
    if table.device.type == "cpu":
        return rating_vector_plain(csr, table, ids)
    csr, table, ids = HistoryCSR(*(t.contiguous() for t in csr)), table.contiguous(), ids.contiguous()
    B, D = ids.shape[0], table.shape[1]
    firstpos, head_of, piece_start = _scratch(csr, B, table.device)
    out = torch.zeros(B, D, dtype=torch.float32, device=table.device)
    err = build.library("rating_vector").rating_vector_forward(
        csr.ptr.data_ptr(), csr.cols.data_ptr(), csr.ptr.shape[0] - 1, table.data_ptr(), D,
        ids.data_ptr(), B, firstpos.data_ptr(), head_of.data_ptr(), piece_start.data_ptr(),
        out.data_ptr(), build.stream_handle(table),
    )
    build.check(err, "rating_vector_forward")
    rating_vector_forward.launches += 1
    return out


rating_vector_forward.launches = 0


def rating_vector_backward(csr: HistoryCSR, n_rows: int, ids, gout):
    """float32 [n_rows, D]: ``gout[b]`` added into the table row of every
    entry of each id's history."""
    _check(csr, ids, gout, "rating_vector_backward")
    if gout.shape[0] != ids.shape[0]:
        raise ValueError(f"rating_vector_backward: gout {tuple(gout.shape)} for {ids.shape[0]} ids")
    if gout.device.type == "cpu":
        return rating_vector_backward_plain(csr, n_rows, ids, gout)
    csr, ids, gout = HistoryCSR(*(t.contiguous() for t in csr)), ids.contiguous(), gout.contiguous()
    B, D = ids.shape[0], gout.shape[1]
    firstpos, head_of, piece_start = _scratch(csr, B, gout.device)
    gsum = torch.zeros(B, D, dtype=torch.float32, device=gout.device)
    dtable = torch.zeros(n_rows, D, dtype=torch.float32, device=gout.device)
    err = build.library("rating_vector").rating_vector_backward(
        csr.ptr.data_ptr(), csr.cols.data_ptr(), csr.ptr.shape[0] - 1, gout.data_ptr(), D,
        ids.data_ptr(), B, firstpos.data_ptr(), head_of.data_ptr(), piece_start.data_ptr(),
        gsum.data_ptr(), dtable.data_ptr(), build.stream_handle(gout),
    )
    build.check(err, "rating_vector_backward")
    rating_vector_backward.launches += 1
    return dtable


rating_vector_backward.launches = 0


class _RatingVector(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ptr, cols, ids):
        ctx.save_for_backward(ptr, cols, ids)
        ctx.n_rows = table.shape[0]
        return rating_vector_forward(HistoryCSR(ptr, cols), table, ids)

    @staticmethod
    def backward(ctx, g):
        ptr, cols, ids = ctx.saved_tensors
        return (rating_vector_backward(HistoryCSR(ptr, cols), ctx.n_rows, ids, g.contiguous()),
                None, None, None)


def rating_vector(csr: HistoryCSR, table, ids):
    """Differentiable (in ``table``) ``_rating_vector(history, ids, N) @ table``
    for int32 ``ids``: the sum of ``table``'s rows at each id's history."""
    return _RatingVector.apply(table, csr.ptr, csr.cols, ids)
