"""B5: streaming full-sort top-k with history masking.

Port of ``recbole_cdr_tpu/ops/topk.py`` (``streaming_topk_scores``,
``_stream_topk_hist_local``, ``_stream_topk_hist_pairs``,
``streaming_topk_with_history``, ``_merge_tile_topk``, ``_tile_k``): the
scores of a user block against the item table are taken tile by tile along
the item axis, each tile keeps its own top ``min(k, tile)``, and one stable
merge of the candidates in (tile, rank) order gives the global top-k. Column
0 (PAD) and each row's history items score ``finfo(float32).min``; ties go to
the lowest item id, so the ids equal one ``top_k`` over the full masked row.
The [B, I] score matrix is never held.

A row's history arrives in CSR form, ``items[row_ptr[r]:row_ptr[r + 1]]``
(global item ids, any order): tail-robust like the JAX package's pair lists.
The kernel is ``csrc/streaming_topk.cu``, which computes the score product
itself on the tensor cores in 3xTF32 (float32 accuracy: each operand split
into a TF32 high part and residual, three products per score) and selects
from the accumulators; B13 is its bf16 form (``streaming_topk_bf16``: one
16-bit product per score, float32 accumulation, as JAX's ``_score_dot``
with ``preferred_element_type`` float32). The plain version below runs for
CPU tensors and serves as the kernels' reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build

MAX_K = 64

#: item-axis tile of the plain version (the JAX package's STREAM_ITEM_TILE)
STREAM_ITEM_TILE = 32768

#: widest embedding the kernel stages in shared memory
MAX_D = 256


def _tile_k(k: int, tile: int, n_tiles: int) -> int:
    """Per-tile keep count: min(k, tile). A tile holds only ``tile``
    candidates, so keeping them all stays exact when k > tile."""
    kt = min(k, tile)
    if n_tiles * kt < k:
        raise ValueError(f"top-k {k} exceeds the padded item axis ({n_tiles}x{tile})")
    return kt


def _stable_topk(scores, k: int):
    """(values, positions) of the k best of each row, ties to the lowest
    position (a stable descending sort)."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, order), order


def _merge_tile_topk(ss, ii, k: int):
    """[n_tiles, B, kt] per-tile winners -> global (scores, ids) [B, k]. The
    candidates concatenate in (tile, rank) order, so the stable merge keeps
    the lowest-id tie-break."""
    n_tiles, B, kt = ss.shape
    cat_s = ss.transpose(0, 1).reshape(B, n_tiles * kt)
    cat_i = ii.transpose(0, 1).reshape(B, n_tiles * kt)
    best, pos = _stable_topk(cat_s, k)
    return best, cat_i.gather(1, pos)


def streaming_topk_plain(user_e, item_table, row_ptr, items, k: int,
                         tile: int = STREAM_ITEM_TILE):
    """The JAX package's tiled algorithm on the padded item axis: columns at
    or past I score ``finfo.min`` with ids >= I, as there."""
    B = user_e.shape[0]
    I = item_table.shape[0]
    n_tiles = -(-I // tile)
    kt = _tile_k(k, tile, n_tiles)
    neg = torch.finfo(torch.float32).min
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(B, device=user_e.device), counts)
    lo = int(row_ptr[0])
    hist = items[lo:lo + rows.shape[0]].to(torch.int64)
    ss, ii = [], []
    for t in range(n_tiles):
        start = t * tile
        scores = torch.full((B, tile), neg, dtype=torch.float32, device=user_e.device)
        block = item_table[start:start + tile]
        scores[:, :block.shape[0]] = user_e @ block.T
        if start == 0:
            scores[:, 0] = neg
        sel = (hist >= start) & (hist < start + tile)
        scores[rows[sel], hist[sel] - start] = neg
        s, p = _stable_topk(scores, kt)
        ss.append(s)
        ii.append(p.to(torch.int32) + start)
    return _merge_tile_topk(torch.stack(ss), torch.stack(ii), k)


#: the factors' types of the kernels: float32 (B5), and bfloat16 (B13) or
#: float16 through B13's template; the C interface's type code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(user_e, item_table, row_ptr, items, k: int):
    if user_e.dtype not in DTYPES or item_table.dtype != user_e.dtype:
        raise TypeError(f"streaming_topk takes factors of one type of {tuple(DTYPES)}: "
                        f"{user_e.dtype}, {item_table.dtype}")
    if user_e.dim() != 2 or item_table.dim() != 2 or user_e.shape[1] != item_table.shape[1]:
        raise ValueError(f"streaming_topk factors must be [B, D] and [I, D]: "
                         f"{user_e.shape}, {item_table.shape}")
    if row_ptr.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError("streaming_topk takes int32 row_ptr and items")
    B = user_e.shape[0]
    I = item_table.shape[0]
    if row_ptr.shape != (B + 1,) or items.dim() != 1:
        raise ValueError(f"streaming_topk: row_ptr {row_ptr.shape} for {B} rows, "
                         f"items {items.shape}")
    if not 1 <= k <= min(MAX_K, I):
        raise ValueError(f"streaming_topk takes 1 <= k <= min({MAX_K}, items), got k={k}")
    if len({t.device for t in (user_e, item_table, row_ptr, items)}) != 1:
        raise ValueError("streaming_topk operands must share one device")
    if user_e.device.type not in ("cpu", "cuda"):
        raise ValueError(f"streaming_topk has no version for device {user_e.device}")


def _launch(user_e, item_table, row_ptr, items, k: int, name: str):
    """One call of the kernel for the factors' type (B5 or B13)."""
    B, D = user_e.shape
    I = item_table.shape[0]
    if D > MAX_D:
        raise ValueError(f"streaming_topk stages rows of at most {MAX_D} values, got D={D}")
    lib = build.library("streaming_topk")
    code = DTYPES[user_e.dtype]
    user_e, item_table = user_e.contiguous(), item_table.contiguous()
    row_ptr, items = row_ptr.contiguous(), items.contiguous()
    dev = user_e.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    n_splits = lib.streaming_topk_splits(B, I, D, k, code)
    if n_splits < 0:
        build.check(-n_splits, name)
    # the history set: (row, item) keys at a load factor of at most 1/2,
    # sized from the shape alone (no device sync)
    bits = max(10, (2 * items.shape[0] - 1).bit_length())
    table = torch.empty(1 << bits, dtype=torch.int64, device=dev)
    cand_s = torch.empty((n_splits, B, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_splits, B, k), dtype=torch.int32, device=dev)
    err = lib.streaming_topk(
        user_e.data_ptr(), item_table.data_ptr(), B, I, D, row_ptr.data_ptr(),
        items.data_ptr(), k, table.data_ptr(), bits, n_splits, cand_s.data_ptr(),
        cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), code,
        build.stream_handle(user_e),
    )
    build.check(err, name)
    return out_s, out_i


def streaming_topk(user_e, item_table, row_ptr, items, k: int):
    """(scores float32 [B, k], ids int32 [B, k]) of the k best masked items of
    each row of ``user_e @ item_table.T``.

    user_e: [B, D]; item_table: [I, D], both float32 (B5) or both bfloat16
    or float16 (handed to :func:`streaming_topk_bf16`, never converted);
    row_ptr: int32 [B + 1]; items: int32 [P]; 1 <= k <= min(64, I)."""
    _check(user_e, item_table, row_ptr, items, k)
    if user_e.dtype != torch.float32:
        return streaming_topk_bf16(user_e, item_table, row_ptr, items, k)
    if user_e.device.type == "cpu":
        return streaming_topk_plain(user_e, item_table, row_ptr, items, k)
    out = _launch(user_e, item_table, row_ptr, items, k, "streaming_topk")
    streaming_topk.launches += 1
    return out


streaming_topk.launches = 0


def streaming_topk_bf16_plain(user_e, item_table, row_ptr, items, k: int):
    """B13's plain version: both 16-bit operands upcast exactly, then
    :func:`streaming_topk_plain`."""
    return streaming_topk_plain(user_e.float(), item_table.float(), row_ptr, items, k)


def streaming_topk_bf16(user_e, item_table, row_ptr, items, k: int):
    """B13: :func:`streaming_topk` on bfloat16 (or float16) factors, each
    product of 16-bit operands accumulated in float32 on the tensor cores.
    The plain version upcasts both operands exactly (``.float()``) and runs
    :func:`streaming_topk_plain`: every 16-bit product is exact in float32,
    so the two differ only in the order of the float32 sums."""
    _check(user_e, item_table, row_ptr, items, k)
    if user_e.dtype == torch.float32:
        raise TypeError("streaming_topk_bf16 takes 16-bit factors")
    if user_e.device.type == "cpu":
        return streaming_topk_bf16_plain(user_e, item_table, row_ptr, items, k)
    out = _launch(user_e, item_table, row_ptr, items, k, "streaming_topk_bf16")
    streaming_topk_bf16.launches += 1
    return out


streaming_topk_bf16.launches = 0
