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
for CPU tensors and serves as the kernel's reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build

#: the kernel's chunk of a row staged in shared memory, and its budget
CHUNK = 2048
SMEM_LIMIT = 227 * 1024


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


def smem_bytes(I: int, P: int) -> int:
    """The kernel's dynamic shared memory: the row's mask bitmap, a staged
    chunk, and per valid positive its masked score and two counters."""
    return 4 * ((I + 31) // 32) + 4 * CHUNK + 12 * max(P, 1)


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
    if smem_bytes(I, P) > SMEM_LIMIT:
        raise ValueError(f"rank_sum: {I} items and {P} positives per row exceed the "
                         "kernel's shared memory")
    scores, row_ptr, items, pos, pos_mask = (
        t.contiguous() for t in (scores, row_ptr, items, pos, pos_mask))
    out = torch.empty(B, dtype=torch.float32, device=scores.device)
    err = build.library("rank_sum").rank_sum(
        scores.data_ptr(), B, I, row_ptr.data_ptr(), items.data_ptr(), pos.data_ptr(),
        pos_mask.data_ptr(), P, CHUNK, out.data_ptr(), build.stream_handle(scores),
    )
    build.check(err, "rank_sum")
    rank_sum.launches += 1
    return out


rank_sum.launches = 0
