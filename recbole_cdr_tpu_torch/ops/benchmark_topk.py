"""B12: DCDCSR's benchmark top-k and blend.

Port of the non-overlapped part of ``recbole_cdr_tpu/models/dcdcsr.py:179-189
DCDCSR._build_benchmark``: for each row of ``rest`` [M, D] (the target
table's rows past the overlap), the similarities to the ``n_ov`` overlapped
source rows, their top k (largest first, the lower index first on a tie, as
``lax.top_k``), and the blend of the row with the similarity-weighted mean
of those k source rows, weighted by the popularity ratio ``beta = sn / (sn +
t_pop)`` (``sn`` the mean source popularity of the k rows; NaN where both
are 0, as in JAX). The kernel is ``csrc/benchmark_topk.cu``: the tensor
cores screen the similarities in 3xTF32 and the float32 chains of a short
list per row give the results, so they do not depend on the launch's split
into column ranges (:func:`benchmark_topk_plan`). The plain version below
runs for CPU tensors and serves as the kernel's reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build

#: the largest k the kernel takes (its lists hold 16 or 32 entries)
MAX_K = 32
#: the most column ranges the kernel splits the similarities into
MAX_SPLITS = 8
#: rest rows of a screening block, source rows of its tiles and stages of
#: its ring (``kRows``, ``kCols`` and ``kStages`` of the source)
ROWS = 64
COLS = 64
STAGES = 2
#: a column range's fixed cost in tiles, as the launch plan counts it
RANGE_COST = 3


def screen_error(D: int, ma, mb):
    """e: how far a 3xTF32 screened similarity may lie from the float32
    chain, for rows whose largest |value| are ``ma`` and ``mb``
    (``row_err`` of the source, whose header derives it)."""
    return (D + 8) * 2.0 ** -19 * D * ma * mb + D * 2.0 ** -125 * (1 + ma + mb)


def list_room(k: int) -> int:
    """Candidates a screening block lists per row (``room`` of the source):
    a tile's 64 and, for k > 16, 32 more."""
    return 64 if k <= 16 else 96


def screen_smem_bytes(k: int) -> int:
    """A screening block's shared memory (``screen_smem_bytes`` of the
    source): the ring of rest and source slices, a tile's scores, the rows'
    largest |value|, each row's list (lower and upper key and id) and its
    four counters."""
    ring = STAGES * (ROWS + COLS) * 36
    return 4 * (ring + ROWS * (COLS + 4) + ROWS + COLS) + 12 * ROWS * list_room(k) + 16 * ROWS


def blocks_per_sm(k: int) -> int:
    """Screening blocks an SM holds at once: two of 103 KB, or one of 127 KB
    with the 96-entry lists of k > 16 (:func:`screen_smem_bytes`)."""
    return 2 if k <= 16 else 1


def benchmark_topk_plan(M: int, n_ov: int, k: int, sms: int):
    """(splits, span): the column ranges of the screening launch over ``M``
    rows, ``span`` source rows each (whole tiles of ``COLS``; every range
    holds some). A block's time is about its range's tiles plus
    ``RANGE_COST`` tiles (its first tile's bar, the lists' pruning and
    rescoring); the SMs' ``sms * blocks_per_sm(k)`` slots run
    ``ceil(M / ROWS) * splits`` blocks, so the launch takes about a block's
    time times max(1, blocks / slots). The count minimizing that is taken,
    the fewest on a tie."""
    if M < 1 or n_ov < 1 or not 1 <= k <= MAX_K or sms < 1:
        raise ValueError(f"benchmark_topk_plan: M {M}, n_ov {n_ov}, k {k}, sms {sms}")
    row_blocks = -(-M // ROWS)
    tiles = -(-n_ov // COLS)
    slots = sms * blocks_per_sm(k)
    best = None
    for want in range(1, min(MAX_SPLITS, tiles) + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = (per + RANGE_COST) * max(1.0, row_blocks * splits / slots)
        if best is None or cost < best[0]:
            best = (cost, splits, per * COLS)
    return best[1], best[2]


def benchmark_topk_plain(rest, src, s_pop, t_pop, k: int):
    """(out [M, D], idx int32 [M, k], sim [M, k]) by torch.matmul and a stable
    descending sort (equal similarities keep the lower index first: most
    rows of a table whose rows are zero have every similarity exactly 0)."""
    sims = rest @ src.T
    order = torch.sort(sims, dim=1, descending=True, stable=True)
    sim, idx = order.values[:, :k], order.indices[:, :k]
    sn = s_pop[idx].mean(1)
    beta = sn / (sn + t_pop)
    sim_e = torch.einsum("mk,mkd->md", sim, src[idx])
    sum_sim = sim.sum(1)
    sum_sim = torch.where(sum_sim > 0, sum_sim, torch.ones_like(sum_sim))
    out = (1 - beta)[:, None] * rest + beta[:, None] * (sim_e / sum_sim[:, None])
    return out, idx.to(torch.int32), sim


def benchmark_topk(rest, src, s_pop, t_pop, k: int):
    """The benchmark rows of ``rest`` [M, D] against the overlapped source
    rows ``src`` [n_ov, D]: (out [M, D], idx int32 [M, k], sim [M, k]).

    s_pop: float32 [n_ov], the source popularity of each overlapped row;
    t_pop: float32 [M], the target popularity of each row of ``rest``;
    1 <= k <= min(32, n_ov)."""
    tensors = (rest, src, s_pop, t_pop)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("benchmark_topk takes float32 tables and popularities")
    if rest.dim() != 2 or src.dim() != 2 or rest.shape[1] != src.shape[1]:
        raise ValueError(f"benchmark_topk tables must be [M, D] and [n_ov, D]: "
                         f"{tuple(rest.shape)}, {tuple(src.shape)}")
    M, D = rest.shape
    n_ov = src.shape[0]
    if s_pop.shape != (n_ov,) or t_pop.shape != (M,):
        raise ValueError(f"benchmark_topk takes s_pop [{n_ov}] and t_pop [{M}]: "
                         f"{tuple(s_pop.shape)}, {tuple(t_pop.shape)}")
    if not 1 <= k <= min(MAX_K, n_ov):
        raise ValueError(f"benchmark_topk takes 1 <= k <= min({MAX_K}, overlapped rows "
                         f"{n_ov}), got k={k}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("benchmark_topk operands must share one device")
    dev = rest.device
    if dev.type == "cpu":
        return benchmark_topk_plain(rest, src, s_pop, t_pop, k)
    if dev.type != "cuda":
        raise ValueError(f"benchmark_topk has no version for device {dev}")
    rest, src, s_pop, t_pop = (t.contiguous() for t in tensors)
    lib, stream = build.library("benchmark_topk"), build.stream_handle(rest)
    # the rows that hold a value other than 0, listed; an all-zero row's
    # similarities are all 0, so it takes the first k ids without a screen
    nonzero = torch.empty(M, dtype=torch.int32, device=dev)
    rows = torch.empty(M, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    build.check(lib.benchmark_topk_rows(rest.data_ptr(), M, D, nonzero.data_ptr(),
                                        rows.data_ptr(), count.data_ptr(), stream),
                "benchmark_topk")
    n_rows = int(count.item())  # the launch's size: the call's one wait for the card
    splits, span = benchmark_topk_plan(
        max(n_rows, 1), n_ov, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    width = 16 if k <= 16 else 32
    part_val = torch.empty((splits, M, width), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, M, width), dtype=torch.int32, device=dev)
    out = torch.empty((M, D), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    sim = torch.empty((M, k), dtype=torch.float32, device=dev)
    err = lib.benchmark_topk(
        rest.data_ptr(), src.data_ptr(), s_pop.data_ptr(), t_pop.data_ptr(), M,
        nonzero.data_ptr(), rows.data_ptr(), n_rows, n_ov, D, k, splits, span,
        part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(), idx.data_ptr(),
        sim.data_ptr(), stream,
    )
    build.check(err, "benchmark_topk")
    benchmark_topk.launches += 1
    return out, idx, sim


benchmark_topk.launches = 0
