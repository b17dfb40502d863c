"""B5: streaming full-sort top-k with history masking; B13, its bf16 form;
B14, its mesh-sharded form.

Port of ``recbole_cdr_tpu/ops/topk.py`` (``streaming_topk_scores``,
``_stream_topk_hist_local``, ``_stream_topk_hist_pairs``,
``streaming_topk_with_history``, ``_merge_tile_topk``, ``_tile_k``,
``make_sharded_streaming_topk``): the
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
from the accumulators. B13 (``streaming_topk_bf16``: one 16-bit product per
score, float32 accumulation, as JAX's ``_score_dot`` with
``preferred_element_type`` float32) has its own tile kernel in the same
source, on wgmma fed by TMA with a warp-private selection, under the launch
plan :func:`streaming_topk_bf16_plan`. B14
(:func:`sharded_streaming_topk`) splits the item axis over a mesh's
``model`` axis: each rank runs B5's or B13's tile kernel on its rows of the
table at their global offset (:func:`sharded_topk_local`), an ``all_gather`` over
the model group collects the m [B, k] lists, and a merge kernel places each
candidate by its rank (:func:`sharded_topk_merge`); the ids equal one call
over the whole table. The plain versions below run for CPU tensors and serve as the
kernels' reference.
"""

import torch
import torch.distributed as dist

from recbole_cdr_tpu_torch.ops import build

MAX_K = 64

#: item-axis tile of the plain version (the JAX package's STREAM_ITEM_TILE)
STREAM_ITEM_TILE = 32768

#: widest embedding the kernel stages in shared memory
MAX_D = 256


INT32_MAX = 2 ** 31 - 1


def _stable_topk(scores, k: int):
    """(values, positions) of the k best of each row, ties to the lowest
    position (a stable descending sort)."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, order), order


def _merge_lists(ss, ii, k: int):
    """[n, B, kt] candidate lists -> global (scores, ids) [B, k]. The
    candidates concatenate in (list, rank) order, so the stable merge keeps
    the lowest-id tie-break when the lists' ids ascend with the list; fewer
    than k candidates pad with (-inf, INT32_MAX)."""
    n, B, kt = ss.shape
    cat_s = ss.transpose(0, 1).reshape(B, n * kt)
    cat_i = ii.transpose(0, 1).reshape(B, n * kt)
    if n * kt < k:
        cat_s = torch.cat([cat_s, cat_s.new_full((B, k - n * kt), -torch.inf)], 1)
        cat_i = torch.cat([cat_i, cat_i.new_full((B, k - n * kt), INT32_MAX)], 1)
    best, pos = _stable_topk(cat_s, k)
    return best, cat_i.gather(1, pos)


def _stream_plain(user_e, block, row_ptr, items, k: int, col_offset: int, n_valid: int,
                  tile: int):
    """The JAX package's tiled algorithm (``_stream_topk_hist_local``) over
    rows ``[0, n_valid)`` of ``block``, whose row j is global item
    ``col_offset + j``: per tile the scores, global column 0 (PAD) and each
    row's history (global ids) at ``finfo.min``, the tile's top
    ``min(k, tile)``, then one stable merge. Columns past ``n_valid`` never
    compete: they pad a tile with (-inf, INT32_MAX), as the kernel pads a
    short item range."""
    B = user_e.shape[0]
    dev = user_e.device
    neg = torch.finfo(torch.float32).min
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(B, device=dev), counts)
    lo = int(row_ptr[0])
    hist = items[lo:lo + rows.shape[0]].to(torch.int64) - col_offset  # local columns
    ss, ii = [], []
    for start in range(0, max(n_valid, 1), tile):
        n = max(0, min(tile, n_valid - start))
        scores = torch.full((B, tile), -torch.inf, dtype=torch.float32, device=dev)
        ids = torch.full((tile,), INT32_MAX, dtype=torch.int32, device=dev)
        scores[:, :n] = user_e @ block[start:start + n].T
        ids[:n] = torch.arange(col_offset + start, col_offset + start + n, dtype=torch.int32,
                               device=dev)
        if col_offset == 0 and start == 0 and n > 0:
            scores[:, 0] = neg
        sel = (hist >= start) & (hist < start + n)
        scores[rows[sel], hist[sel] - start] = neg
        s, p = _stable_topk(scores, min(k, tile))
        ss.append(s)
        ii.append(ids[p])
    return _merge_lists(torch.stack(ss), torch.stack(ii), k)


def streaming_topk_plain(user_e, item_table, row_ptr, items, k: int,
                         tile: int = STREAM_ITEM_TILE):
    """The JAX package's tiled algorithm over the whole item table."""
    return _stream_plain(user_e, item_table, row_ptr, items, k, 0, item_table.shape[0], tile)


#: the factors' types of the kernels: float32 (B5), and bfloat16 (B13) or
#: float16 through B13's template; the C interface's type code
DTYPES = build.DTYPES


def _check(user_e, item_table, row_ptr, items, k: int, total_items=None):
    if user_e.dtype not in DTYPES or item_table.dtype != user_e.dtype:
        raise TypeError(f"streaming_topk takes factors of one type of {tuple(DTYPES)}: "
                        f"{user_e.dtype}, {item_table.dtype}")
    if user_e.dim() != 2 or item_table.dim() != 2 or user_e.shape[1] != item_table.shape[1]:
        raise ValueError(f"streaming_topk factors must be [B, D] and [I, D]: "
                         f"{user_e.shape}, {item_table.shape}")
    if row_ptr.dtype != torch.int32 or items.dtype != torch.int32:
        raise TypeError("streaming_topk takes int32 row_ptr and items")
    B = user_e.shape[0]
    I = item_table.shape[0] if total_items is None else total_items
    if row_ptr.shape != (B + 1,) or items.dim() != 1:
        raise ValueError(f"streaming_topk: row_ptr {row_ptr.shape} for {B} rows, "
                         f"items {items.shape}")
    if not 1 <= k <= min(MAX_K, I):
        raise ValueError(f"streaming_topk takes 1 <= k <= min({MAX_K}, items), got k={k}")
    if len({t.device for t in (user_e, item_table, row_ptr, items)}) != 1:
        raise ValueError("streaming_topk operands must share one device")
    if user_e.device.type not in ("cpu", "cuda"):
        raise ValueError(f"streaming_topk has no version for device {user_e.device}")


#: B13's tile kernel (``streaming_topk_16``): items per tile (the wgmma N),
#: values of D per 128-byte swizzled box, survivor slots per row (the
#: source's kCap16), the bounds
#: of its ring of item boxes, and its consumer warpgroups of 64 user rows (4
#: where the shared memory allows: the more warps, the more of the
#: selection's latency hides)
B13_TILE = 64
B13_BOX = 64
B13_CAP = 32
B13_MIN_STAGES = 4
B13_MAX_STAGES = 8
B13_WARPGROUPS = (4, 2)
#: shared memory a block may use on an H100
SMEM_LIMIT = 232_448


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def b13_smem_bytes(wgs: int, boxes: int, stages: int, k: int) -> int:
    """B13's shared memory (``smem16_bytes`` in the source, plus 1,024 bytes
    to align it): the block's 64 ``wgs`` user rows, the ring of [64 items x
    128 B] item boxes, each row's list and buffer of (score, id) pairs (the
    buffer's row stride B13_CAP + 1), and the ring's and the user rows' full
    and empty barriers."""
    rows = 64 * wgs
    return (boxes * rows * 128 + stages * B13_TILE * 128 + 8 * rows * (k + B13_CAP + 1)
            + 8 * (2 * stages + 2) + 1024)


def streaming_topk_bf16_plan(B: int, I: int, D: int, k: int, n_sms: int) -> dict:
    """B13's launch plan for [B, D] users against [I, D] items: a pure
    function of the shape and the SM count.

    A block holds ``rows`` = 64 ``wgs`` user rows (``wgs`` consumer
    warpgroups of one m64 tile each: 4, so that every item tile fetched
    serves 256 users, where the shared memory allows, else 2) and a ring of
    ``stages`` item boxes (one box per 64 values of D, at least 4 and at
    least one tile's boxes). The item axis splits into ``n_ranges`` ranges
    of ``span`` items (a multiple of the 64-item tile); the work items are
    (row block, range) pairs, ``row_blocks`` x ``n_ranges`` of them, at most
    one per SM where the row blocks allow (a row's threshold then rises over
    one long range: the fewer ranges, the fewer survivors), walked by a
    persistent grid of ``grid`` blocks (one per SM) with the row block
    fastest, so the blocks that run together read one item range. ``tma``:
    TMA stages the boxes (16-byte row pitch, D % 8 == 0), else the producer
    warp stages them element-wise. ``smem``: a block's bytes. ``l2_bytes``:
    the item bytes read from L2 into the SMs (every row block reads the
    whole table once)."""
    if B < 1 or I < 1 or not 1 <= D <= MAX_D or not 1 <= k <= min(MAX_K, I) or n_sms < 1:
        raise ValueError(f"streaming_topk_bf16_plan: no plan for B={B}, I={I}, D={D}, "
                         f"k={k}, sms={n_sms}")
    boxes = _cdiv(D, B13_BOX)
    least = max(B13_MIN_STAGES, boxes)
    fits = ((wgs, s) for wgs in B13_WARPGROUPS
            for s in range(max(B13_MAX_STAGES, least), least - 1, -1)
            if b13_smem_bytes(wgs, boxes, s, k) <= SMEM_LIMIT)
    wgs, stages = next(fits, (None, None))
    if wgs is None:
        raise ValueError(f"streaming_topk_bf16: D={D}, k={k} do not fit one block's "
                         "shared memory")
    rows = 64 * wgs
    row_blocks = _cdiv(B, rows)
    tiles = _cdiv(I, B13_TILE)
    n_ranges = min(tiles, max(1, n_sms // row_blocks))
    span = _cdiv(tiles, n_ranges) * B13_TILE
    n_ranges = _cdiv(I, span)
    return {"wgs": wgs, "rows": rows, "stages": stages, "boxes": boxes, "span": span,
            "n_ranges": n_ranges, "row_blocks": row_blocks,
            "grid": min(row_blocks * n_ranges, n_sms), "tma": D % 8 == 0,
            "smem": b13_smem_bytes(wgs, boxes, stages, k),
            "l2_bytes": row_blocks * I * D * 2}


def _history_table(items, dev):
    """The history set's scratch: (row, item) keys at a load factor of at
    most 1/2, sized from the shape alone (no device sync)."""
    bits = max(10, (2 * items.shape[0] - 1).bit_length())
    return torch.empty(1 << bits, dtype=torch.int64, device=dev), bits


def _launch(user_e, item_table, row_ptr, items, k: int, name: str, col_offset: int = 0):
    """One call of the kernel for the factors' type (B5 or B13; B14's local
    stage with the rows' global offset)."""
    B, D = user_e.shape
    I = item_table.shape[0]
    if D > MAX_D:
        raise ValueError(f"streaming_topk stages rows of at most {MAX_D} values, got D={D}")
    lib = build.library("streaming_topk")
    user_e, item_table = user_e.contiguous(), item_table.contiguous()
    row_ptr, items = row_ptr.contiguous(), items.contiguous()
    dev = user_e.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_s, out_i
    table, bits = _history_table(items, dev)
    if user_e.dtype == torch.float32:
        n_splits = lib.streaming_topk_splits(B, I, D, k)
        if n_splits < 0:
            build.check(-n_splits, name)
        cand_s = torch.empty((n_splits, B, k), dtype=torch.float32, device=dev)
        cand_i = torch.empty((n_splits, B, k), dtype=torch.int32, device=dev)
        err = lib.streaming_topk(
            user_e.data_ptr(), item_table.data_ptr(), B, I, D, row_ptr.data_ptr(),
            items.data_ptr(), k, table.data_ptr(), bits, n_splits, cand_s.data_ptr(),
            cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), col_offset,
            build.stream_handle(user_e),
        )
    else:
        plan = streaming_topk_bf16_plan(
            B, I, D, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        cand_s = torch.empty((plan["n_ranges"], B, k), dtype=torch.float32, device=dev)
        cand_i = torch.empty((plan["n_ranges"], B, k), dtype=torch.int32, device=dev)
        err = lib.streaming_topk_16(
            user_e.data_ptr(), item_table.data_ptr(), B, I, D, row_ptr.data_ptr(),
            items.data_ptr(), k, table.data_ptr(), bits, plan["wgs"], plan["stages"],
            plan["span"], plan["n_ranges"], plan["grid"], int(plan["tma"]),
            cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            DTYPES[user_e.dtype], col_offset, build.stream_handle(user_e),
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
    product of 16-bit operands accumulated in float32 on the tensor cores
    (wgmma), one launch of the tile kernel a call under
    :func:`streaming_topk_bf16_plan`.
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


def sharded_topk_local_plain(user_e, block, row_ptr, items, k: int, col_offset: int,
                             total_items: int, tile: int = STREAM_ITEM_TILE):
    """B14's local stage, plain: the streaming top-k of ``block`` (row j is
    global item ``col_offset + j``; rows at or past ``total_items`` are
    padding and never compete), 16-bit factors upcast exactly."""
    n_valid = max(0, min(block.shape[0], total_items - col_offset))
    return _stream_plain(user_e.float(), block.float(), row_ptr, items, k, col_offset,
                         n_valid, tile)


def sharded_topk_local(user_e, block, row_ptr, items, k: int, col_offset: int,
                       total_items: int):
    """B14's local stage: (scores float32 [B, k], global ids int32 [B, k]),
    the k best of each row of ``user_e @ block.T`` by (score desc, id asc),
    where row j of ``block`` is global item ``col_offset + j``, global column
    0 (PAD) and each row's history items (CSR of global ids, as
    :func:`streaming_topk`) score ``finfo(float32).min``, and the rows at or
    past ``total_items`` (the last shard's padding) never compete: a shard
    with fewer than k such rows pads its list with (-inf, INT32_MAX).
    Float32 factors run B5's tile kernel, 16-bit ones B13's, at the offset;
    1 <= k <= min(64, total_items)."""
    _check(user_e, block, row_ptr, items, k, total_items)
    if user_e.device.type == "cpu":
        return sharded_topk_local_plain(user_e, block, row_ptr, items, k, col_offset,
                                        total_items)
    n_valid = max(0, min(block.shape[0], total_items - col_offset))
    if n_valid == 0:  # a shard wholly past the items: nothing to launch
        B = user_e.shape[0]
        return (torch.full((B, k), -torch.inf, device=user_e.device),
                torch.full((B, k), INT32_MAX, dtype=torch.int32, device=user_e.device))
    out = _launch(user_e, block[:n_valid], row_ptr, items, k, "sharded_topk_local",
                  col_offset)
    sharded_topk_local.launches += 1
    return out


sharded_topk_local.launches = 0


def sharded_topk_merge_plain(cand_s, cand_i, k: int):
    """B14's merge, plain: the stable merge of the lists concatenated in
    shard order (JAX ``top_k`` over the gathered candidates)."""
    return _merge_lists(cand_s, cand_i, k)


#: the most candidates of a row the merge kernel stages (its scores and ids
#: within 48 KB of shared memory)
MAX_MERGE_CANDIDATES = 6144


def sharded_topk_merge(cand_s, cand_i, k: int):
    """B14's merge: (scores [B, k], ids [B, k]) of the k best of the m
    candidate lists ``cand_s`` float32 / ``cand_i`` int32 [m, B, k] (the
    model group's local stages, in shard order) by (score desc, id asc).

    Requires what :func:`sharded_topk_local` writes: each row's list sorted
    by (score desc, id asc), padded at its end with (-inf, INT32_MAX), and
    the ids of an earlier list below those of a later one. The kernel places
    candidate r of list l at r plus the entries of earlier lists that score
    at least as high and of later lists that score higher (a binary search
    of each), which is the stable merge of the lists concatenated in order
    (:func:`sharded_topk_merge_plain`) only for sorted lists."""
    if (cand_s.dim() != 3 or cand_s.shape != cand_i.shape or cand_s.dtype != torch.float32
            or cand_i.dtype != torch.int32 or cand_s.device != cand_i.device):
        raise ValueError(f"sharded_topk_merge takes float32 / int32 lists [m, B, k]: "
                         f"{cand_s.shape} {cand_s.dtype}, {cand_i.shape} {cand_i.dtype}")
    if not 1 <= k <= MAX_K or cand_s.shape[2] != k:
        raise ValueError(f"sharded_topk_merge takes lists of k, 1 <= k <= {MAX_K}: "
                         f"{cand_s.shape[2]}, k={k}")
    if cand_s.shape[0] * k > MAX_MERGE_CANDIDATES:
        raise ValueError(f"sharded_topk_merge takes at most {MAX_MERGE_CANDIDATES} "
                         f"candidates a row: {cand_s.shape[0]} lists of {k}")
    if cand_s.device.type == "cpu":
        return sharded_topk_merge_plain(cand_s, cand_i, k)
    if cand_s.device.type != "cuda":
        raise ValueError(f"sharded_topk_merge has no version for device {cand_s.device}")
    m, B, _ = cand_s.shape
    out_s = torch.empty((B, k), dtype=torch.float32, device=cand_s.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=cand_s.device)
    cand_s, cand_i = cand_s.contiguous(), cand_i.contiguous()
    err = build.library("streaming_topk").streaming_topk_merge(
        cand_s.data_ptr(), cand_i.data_ptr(), B, m, k, out_s.data_ptr(), out_i.data_ptr(),
        build.stream_handle(cand_s))
    build.check(err, "sharded_topk_merge")
    sharded_topk_merge.launches += 1
    return out_s, out_i


sharded_topk_merge.launches = 0


def sharded_streaming_topk(user_e, block, row_ptr, items, k: int, col_offset: int,
                           total_items: int, group):
    """B14: the streaming top-k of ``user_e`` against an item table split
    over ``group`` (the model group: rank j holds rows ``[j L, (j + 1) L)``
    as ``block``, at ``col_offset`` = j L): the local stage on this rank's
    rows, an ``all_gather`` of the m [B, k] lists over ``group``, then the
    merge. Every rank of the group passes the same users and history and
    gets the same (scores, ids) [B, k], equal to one :func:`streaming_topk`
    over the whole table."""
    s, i = sharded_topk_local(user_e, block, row_ptr, items, k, col_offset, total_items)
    return sharded_topk_merge(_all_gather(s, group), _all_gather(i, group), k)


def _all_gather(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def sharded_streaming_topk_plain(user_e, item_table, row_ptr, items, k: int, m: int):
    """B14 in one process, plain: the table split into m shards of
    ceil(I / m) rows, each shard's local stage at its offset, then the merge.
    Equals :func:`streaming_topk_plain` over the whole table."""
    I = item_table.shape[0]
    L = -(-I // m)
    lists = [sharded_topk_local_plain(user_e, item_table[j * L:(j + 1) * L], row_ptr, items, k,
                                      j * L, I) for j in range(m)]
    return sharded_topk_merge_plain(torch.stack([s for s, _ in lists]),
                                    torch.stack([i for _, i in lists]), k)
