"""B7: the GAUC rank sums of the dense full-sort evaluator.

Port of ``recbole_cdr_tpu/evaluator/evaluator.py:63-78 _pos_rank_sum`` on
the row that ``_apply_masks_pairs`` (:40-52) masks, as ``_fused_program``
(:313-327) chains them: the history items of each row take ``min(score,
finfo(float32).min)`` (an existing ``-inf`` stays ``-inf``), then column 0
(PAD) is set to ``finfo(float32).min``. For every valid positive ``p`` of a
row, with ``s_p`` its masked score, the row's sum gains ``#{s > s_p} +
(#{s == s_p} + 1) / 2`` over the whole masked row. A positive inside the
history takes its masked value, as in JAX.

Every rank is a half-integer below 2^22, so the float32 sums are exact, in
any order, while a row's sum stays below 2^23 (for example 5,001 items and
up to 1,600 positives): there the kernel equals the plain version and JAX
exactly. The kernel is ``csrc/rank_sum.cu``; the plain version below runs
for CPU tensors and serves as the kernel's reference. :func:`rank_sum_plan`
is the kernel's launch plan, handed to its C entries: one block a row on
dense tiles, a row over a thread-block cluster on short ones.

The candidate form (:func:`rank_sum_candidates`) ranks over sampled
candidate lists, as ``evaluate_candidates`` does (`evaluator.py:661-675`):
the row is ``np.where(cand_mask, scores, -inf)``, each row's positives are
the columns ``pos_mask`` marks, and there is no history and no PAD column
(column 0 is the row's first positive). The same kernel runs it with the
padded slots in place of the history; a positive's column is its own id.
"""

import functools

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.masked_topk import sm_count

#: the kernel's block (8 warps), the portable thread-block cluster size, the
#: fewest columns a block of a cluster takes, and a block's shared memory
#: on an H100
THREADS = 256
MAX_CLUSTER = 8
MIN_SPAN = 256
SMEM_LIMIT = 232_448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def rank_sum_plan(B: int, I: int, P: int, n_sms: int, cand: bool = False) -> dict:
    """The launch plan of B7 on [B, I] scores with P positive slots a row
    (the candidate form, ``cand``: P = I): a pure function of the shape and
    the SM count.

    Dense tiles (``B`` at least ``n_sms``): one block a row (``cluster``
    1). Short tiles: each row's columns split over a cluster of ``cluster``
    blocks, as many as fill the SMs (at most ``MAX_CLUSTER``, at least
    ``MIN_SPAN`` columns a block), block x taking columns [x span, (x + 1)
    span), ``span`` a multiple of 32. ``grid`` is (cluster, B); ``cap`` the
    sorted positives' room (a power of 2 >= P); ``smem`` a block's bytes:
    the sorted list and, for the full-sort form, the row's history bitmap."""
    if B < 1 or I < 1 or P < 0 or n_sms < 1:
        raise ValueError(f"rank_sum_plan: no plan for B={B}, I={I}, P={P}, sms={n_sms}")
    cluster = 1
    if B < n_sms:
        cluster = max(1, min(MAX_CLUSTER, _cdiv(n_sms, B), _cdiv(I, MIN_SPAN)))
    span = _cdiv(_cdiv(I, cluster), 32) * 32
    cluster = _cdiv(I, span)  # no empty block
    cap = 1 << max(0, P - 1).bit_length()
    smem = 4 * cap + (0 if cand else 4 * _cdiv(I, 32))
    if smem > SMEM_LIMIT:
        raise ValueError(f"rank_sum: {I} items and {P} positives per row exceed one block's "
                         "shared memory")
    return {"cluster": cluster, "span": span, "grid": (cluster, B), "cap": cap, "smem": smem}


def launch_plan_args(plan: dict):
    """The plan's ints in the order of the C entries."""
    return plan["cluster"], plan["span"], plan["cap"], plan["smem"]


def masked_scores_plain(scores, row_ptr, items):
    """The [B, I] row masking of ``_apply_masks_pairs``, on a copy."""
    B = scores.shape[0]
    s = scores.clone()
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(B, device=scores.device), counts)
    lo = int(row_ptr[0])
    cols = items[lo:lo + rows.shape[0]].to(torch.int64)
    s[rows, cols] = torch.clamp(s[rows, cols], max=torch.finfo(torch.float32).min)
    s[:, 0] = torch.finfo(torch.float32).min
    return s


def rank_sum_plain(scores, row_ptr, items, pos, pos_mask):
    s = masked_scores_plain(scores, row_ptr, items)
    pv = torch.gather(s, 1, torch.where(pos_mask, pos, 0).to(torch.int64))
    out = torch.zeros(s.shape[0], dtype=torch.float32, device=s.device)
    for j in range(pv.shape[1]):  # one [B, I] comparison per positive column
        v = pv[:, j:j + 1]
        greater = (s > v).sum(1).to(torch.float32)
        tied = (s == v).sum(1).to(torch.float32)
        out += torch.where(pos_mask[:, j], greater + (tied + 1.0) / 2.0, 0.0)
    return out


def rank_sum(scores, row_ptr, items, pos, pos_mask):
    """float32 [B] sums of the average descending ranks of each row's valid
    positives over its masked row.

    scores: float32 [B, I]; row_ptr: int32 [B + 1] and items: int32 [P_h],
    each row's history in CSR form; pos: int32 [B, P] item ids; pos_mask:
    bool [B, P]."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise TypeError("rank_sum takes float32 [B, I] scores")
    if row_ptr.dtype != torch.int32 or items.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("rank_sum takes int32 row_ptr, items and positives")
    if pos_mask.dtype != torch.bool:
        raise TypeError("rank_sum takes a bool positive mask")
    B, I = scores.shape
    if row_ptr.shape != (B + 1,) or items.dim() != 1 or pos.dim() != 2 \
            or pos.shape[0] != B or pos_mask.shape != pos.shape:
        raise ValueError(f"rank_sum: row_ptr {row_ptr.shape}, items {items.shape}, positives "
                         f"{pos.shape} / {pos_mask.shape} for {B} rows")
    if len({t.device for t in (scores, row_ptr, items, pos, pos_mask)}) != 1:
        raise ValueError("rank_sum operands must share one device")
    if scores.device.type == "cpu":
        return rank_sum_plain(scores, row_ptr, items, pos, pos_mask)
    if scores.device.type != "cuda":
        raise ValueError(f"rank_sum has no version for device {scores.device}")
    P = pos.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=scores.device)
    if B == 0:
        return out
    plan = rank_sum_plan(B, I, P, sm_count(scores.device))
    scores, row_ptr, items, pos, pos_mask = (
        t.contiguous() for t in (scores, row_ptr, items, pos, pos_mask))
    err = build.library("rank_sum").rank_sum(
        scores.data_ptr(), B, I, row_ptr.data_ptr(), items.data_ptr(), pos.data_ptr(),
        pos_mask.data_ptr(), P, *launch_plan_args(plan), out.data_ptr(),
        build.stream_handle(scores),
    )
    build.check(err, "rank_sum")
    rank_sum.launches += 1
    return out


rank_sum.launches = 0


def rank_sum_candidates_plain(scores, cand_mask, pos_mask):
    s = torch.where(cand_mask, scores, -torch.inf)
    out = torch.zeros(s.shape[0], dtype=torch.float32, device=s.device)
    for j in torch.nonzero(pos_mask.any(0)).flatten().tolist():  # positive columns only
        v = s[:, j:j + 1]
        greater = (s > v).sum(1).to(torch.float32)
        tied = (s == v).sum(1).to(torch.float32)
        out += torch.where(pos_mask[:, j], greater + (tied + 1.0) / 2.0, 0.0)
    return out


def rank_sum_candidates(scores, cand_mask, pos_mask):
    """float32 [B] sums of the average descending ranks of each row's
    positives (the columns ``pos_mask`` marks) over its candidate row, padded
    slots at -inf.

    scores: float32 [B, C]; cand_mask, pos_mask: bool [B, C]."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise TypeError("rank_sum_candidates takes float32 [B, C] scores")
    if cand_mask.dtype != torch.bool or pos_mask.dtype != torch.bool \
            or cand_mask.shape != scores.shape or pos_mask.shape != scores.shape:
        raise TypeError("rank_sum_candidates takes bool masks of the scores' shape")
    if len({t.device for t in (scores, cand_mask, pos_mask)}) != 1:
        raise ValueError("rank_sum_candidates operands must share one device")
    if scores.device.type == "cpu":
        return rank_sum_candidates_plain(scores, cand_mask, pos_mask)
    if scores.device.type != "cuda":
        raise ValueError(f"rank_sum_candidates has no version for device {scores.device}")
    B, C = scores.shape
    out = torch.empty(B, dtype=torch.float32, device=scores.device)
    if B == 0:
        return out
    plan = rank_sum_plan(B, C, C, sm_count(scores.device), cand=True)
    scores, cand_mask, pos_mask = (t.contiguous() for t in (scores, cand_mask, pos_mask))
    err = build.library("rank_sum").rank_sum_candidates(
        scores.data_ptr(), B, C, cand_mask.data_ptr(), pos_mask.data_ptr(),
        *launch_plan_args(plan), out.data_ptr(), build.stream_handle(scores),
    )
    build.check(err, "rank_sum_candidates")
    rank_sum_candidates.launches += 1
    return out


rank_sum_candidates.launches = 0
