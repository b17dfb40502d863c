"""K4: history-masked full-row top-k of the dense full-sort evaluator.

Port of ``recbole_cdr_tpu/evaluator/evaluator.py:40-52 _apply_masks_pairs``
plus the ``lax.top_k`` of ``_fused_program`` (:299-311): the history items of
each row and column 0 (PAD) are set to ``finfo(float32).min``, then the k
highest scores of each row are taken, ties going to the lowest column. A
row's history arrives in CSR form: ``items[row_ptr[r]:row_ptr[r + 1]]``.
The kernel is ``csrc/masked_topk.cu``; the plain version below runs for CPU
tensors and serves as the kernel's reference. :func:`masked_topk_plan` is
the kernel's launch plan (B10's too), handed to its C entry.
"""

import torch

from recbole_cdr_tpu_torch.ops import build

MAX_K = 64

#: the kernel's block (8 warps), a warp's survivor buffer and the columns a
#: warp tests per step (32 lanes x one float4)
THREADS = 256
WARPS = THREADS // 32
CAP = 256
STEP = 128
#: the portable thread-block cluster size, and the rows per SM below which a
#: tile is short and each row splits over a cluster
MAX_CLUSTER = 8
SHORT_ROWS_PER_SM = 4
#: shared memory a block may use on an H100
SMEM_LIMIT = 232_448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def masked_topk_plan(B: int, I: int, k: int, n_sms: int, cand: bool = False) -> dict:
    """The launch plan of K4 (``cand`` False) or B10 (True) on [B, I]
    scores: a pure function of the shape and the SM count.

    Dense tiles (``B`` above ``SHORT_ROWS_PER_SM`` rows per SM): one chunk
    per row (``cluster`` 1), ``rows_per_block`` rows a block (8, one warp a
    row, where the warps' history bitmaps fit in shared memory). Short tiles:
    one row a block, its columns split into ``cluster`` chunks of ``span``
    columns, one block each, as many as fill the SMs (at most
    ``MAX_CLUSTER``, at least a step per warp). A row's 8 / rows_per_block
    warps split its chunk into segments of ``sub`` columns (multiples of
    4). ``grid`` is (chunks, row blocks); ``smem`` the bytes of a block: K4's
    segment bitmap of each warp, each warp's list and buffer of (score, id)
    pairs and, in a cluster, rank 0's copy of every warp's list of the
    cluster."""
    if B < 1 or I < 1 or not 1 <= k <= min(MAX_K, I) or n_sms < 1:
        raise ValueError(f"masked_topk_plan: no plan for B={B}, I={I}, k={k}, sms={n_sms}")
    state = WARPS * 8 * (k + CAP)
    if B > SHORT_ROWS_PER_SM * n_sms:
        cluster = 1
    else:
        cluster = max(1, min(MAX_CLUSTER, _cdiv(n_sms, B), _cdiv(I, WARPS * STEP)))
    span = _cdiv(_cdiv(I, cluster), 4) * 4
    cluster = _cdiv(I, span)  # no empty chunk
    if cluster > 1:  # cluster rank 0's copy of every warp's list of the cluster
        state += cluster * WARPS * 8 * k
    for rows in (8, 4, 2, 1) if cluster == 1 else (1,):
        sub = _cdiv(_cdiv(span, WARPS // rows), 4) * 4
        smem = (0 if cand else WARPS * 4 * _cdiv(sub, 32)) + state
        if smem <= SMEM_LIMIT:
            return {"rows_per_block": rows, "cluster": cluster, "span": span, "sub": sub,
                    "grid": (cluster, _cdiv(B, rows)), "smem": smem}
    raise ValueError(f"masked_topk: a row of {I} columns does not fit one block's "
                     "shared memory")


def launch_plan_args(plan: dict):
    """The plan's ints in the order of the C entries."""
    return (plan["rows_per_block"], plan["cluster"], plan["span"], plan["sub"], plan["smem"])


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def masked_topk_plain(scores, row_ptr, items, k: int):
    B, I = scores.shape
    s = scores.clone()
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(B, device=scores.device), counts)
    lo = int(row_ptr[0])
    s[rows, items[lo:lo + rows.shape[0]].to(torch.int64)] = torch.finfo(torch.float32).min
    s[:, 0] = torch.finfo(torch.float32).min
    # a stable descending sort keeps equal scores in column order
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def masked_topk(scores, row_ptr, items, k: int):
    """int32 [B, k] column ids of the k best masked scores of each row.

    scores: float32 [B, I]; row_ptr: int32 [B + 1]; items: int32 [P]."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise TypeError("masked_topk takes float32 [B, I] scores")
    if row_ptr.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError("masked_topk takes int32 row_ptr and items")
    B, I = scores.shape
    if row_ptr.shape != (B + 1,) or items.dim() != 1:
        raise ValueError(f"masked_topk: row_ptr {row_ptr.shape} for {B} rows, items {items.shape}")
    if not 1 <= k <= min(MAX_K, I):
        raise ValueError(f"masked_topk takes 1 <= k <= min({MAX_K}, items), got k={k}")
    if len({scores.device, row_ptr.device, items.device}) != 1:
        raise ValueError("masked_topk operands must share one device")
    if scores.device.type == "cpu":
        return masked_topk_plain(scores, row_ptr, items, k)
    if scores.device.type != "cuda":
        raise ValueError(f"masked_topk has no version for device {scores.device}")
    scores, row_ptr, items = scores.contiguous(), row_ptr.contiguous(), items.contiguous()
    out = torch.empty((B, k), dtype=torch.int32, device=scores.device)
    plan = masked_topk_plan(B, I, k, sm_count(scores.device))
    err = build.library("masked_topk").masked_topk(
        scores.data_ptr(), B, I, row_ptr.data_ptr(), items.data_ptr(), k,
        *launch_plan_args(plan), out.data_ptr(), build.stream_handle(scores),
    )
    build.check(err, "masked_topk")
    masked_topk.launches += 1
    return out


masked_topk.launches = 0
