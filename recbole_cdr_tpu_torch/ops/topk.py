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
from the accumulators; the plain version below runs for CPU tensors and
serves as the kernel's reference.
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


def streaming_topk(user_e, item_table, row_ptr, items, k: int):
    """(scores float32 [B, k], ids int32 [B, k]) of the k best masked items of
    each row of ``user_e @ item_table.T``.

    user_e: float32 [B, D]; item_table: float32 [I, D]; row_ptr: int32
    [B + 1]; items: int32 [P]; 1 <= k <= min(64, I)."""
    if user_e.dtype != torch.float32 or item_table.dtype != torch.float32:
        raise TypeError("streaming_topk takes float32 factors")
    if user_e.dim() != 2 or item_table.dim() != 2 or user_e.shape[1] != item_table.shape[1]:
        raise ValueError(f"streaming_topk factors must be [B, D] and [I, D]: "
                         f"{user_e.shape}, {item_table.shape}")
    if row_ptr.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError("streaming_topk takes int32 row_ptr and items")
    B, D = user_e.shape
    I = item_table.shape[0]
    if row_ptr.shape != (B + 1,) or items.dim() != 1:
        raise ValueError(f"streaming_topk: row_ptr {row_ptr.shape} for {B} rows, "
                         f"items {items.shape}")
    if not 1 <= k <= min(MAX_K, I):
        raise ValueError(f"streaming_topk takes 1 <= k <= min({MAX_K}, items), got k={k}")
    if len({t.device for t in (user_e, item_table, row_ptr, items)}) != 1:
        raise ValueError("streaming_topk operands must share one device")
    if user_e.device.type == "cpu":
        return streaming_topk_plain(user_e, item_table, row_ptr, items, k)
    if user_e.device.type != "cuda":
        raise ValueError(f"streaming_topk has no version for device {user_e.device}")
    if D > MAX_D:
        raise ValueError(f"streaming_topk stages rows of at most {MAX_D} floats, got D={D}")
    lib = build.library("streaming_topk")
    user_e, item_table = user_e.contiguous(), item_table.contiguous()
    row_ptr, items = row_ptr.contiguous(), items.contiguous()
    dev = user_e.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    n_splits = lib.streaming_topk_splits(B, I, D, k)
    if n_splits < 0:
        build.check(-n_splits, "streaming_topk")
    # the history set: (row, item) keys at a load factor of at most 1/2,
    # sized from the shape alone (no device sync)
    bits = max(10, (2 * items.shape[0] - 1).bit_length())
    table = torch.empty(1 << bits, dtype=torch.int64, device=dev)
    cand_s = torch.empty((n_splits, B, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_splits, B, k), dtype=torch.int32, device=dev)
    err = lib.streaming_topk(
        user_e.data_ptr(), item_table.data_ptr(), B, I, D, row_ptr.data_ptr(),
        items.data_ptr(), k, table.data_ptr(), bits, n_splits, cand_s.data_ptr(),
        cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), build.stream_handle(user_e),
    )
    build.check(err, "streaming_topk")
    streaming_topk.launches += 1
    return out_s, out_i


streaming_topk.launches = 0
