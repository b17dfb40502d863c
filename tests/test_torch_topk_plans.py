"""The launch plans of the redesigned top-k kernels, held on the CPU.

``masked_topk_plan`` (K4, and B10 under ``cand``) and
``streaming_topk_bf16_plan`` (B13) are plain Python functions that the
wrappers hand to their C entries; the kernels derive every block's work from
them. Over a few hundred shapes drawn with a numpy seed: every (row, column)
or (row, item range) pair is covered exactly once, item ranges are disjoint
and in order, a cluster has at most 8 blocks, a block's shared memory fits
an H100's 232,448 bytes, the C entries' own checks of a plan hold, and the
plan is a pure function of the shape and the SM count.
"""

import numpy as np
import pytest

from recbole_cdr_tpu_torch.ops import masked_topk as k4
from recbole_cdr_tpu_torch.ops import topk as b13

SMEM_LIMIT = 232_448
SMS = (132, 114, 78, 16, 1)


def plan_segments(plan, B, I):
    """Every warp's (row, first column, end column) under a K4 / B10 plan, as
    ``csrc/masked_topk.cu`` derives them from its block and warp indices
    (empty segments left out)."""
    R, span, sub = plan["rows_per_block"], plan["span"], plan["sub"]
    wpr = k4.WARPS // R
    out = []
    for bx in range(plan["grid"][0]):
        c0, c1 = bx * span, min(I, (bx + 1) * span)
        for by in range(plan["grid"][1]):
            for w in range(k4.WARPS):
                row, sw = by * R + w // wpr, w % wpr
                s0, s1 = c0 + sw * sub, min(c1, c0 + (sw + 1) * sub)
                if row < B and s0 < s1:
                    out.append((row, s0, s1))
    return out


def b13_plan_work(plan, B, I):
    """Every (block, user rows, item range) of a B13 plan, in each block's
    order, as ``csrc/streaming_topk.cu`` walks them: block j takes work items
    j, j + grid, ...; item ``w`` is row block ``w % row_blocks``, range
    ``w // row_blocks``."""
    RB, rows, span = plan["row_blocks"], plan["rows"], plan["span"]
    out = []
    for j in range(plan["grid"]):
        for w in range(j, RB * plan["n_ranges"], plan["grid"]):
            rb, rg = w % RB, w // RB
            out.append((j, (rb * rows, min(B, (rb + 1) * rows)),
                        (rg * span, min(I, (rg + 1) * span))))
    return out


def _k4_shapes(seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        B = int(rng.choice([1, 2, 25, 31, 32, 33, 527, 528, 529, 2048, 3000,
                            int(rng.integers(1, 5000))]))
        I = int(rng.choice([1, 7, 12, 128, 2525, 4980, 5001, 600_000,
                            int(rng.integers(1, 1_200_000))]))
        k = int(rng.integers(1, min(64, I) + 1))
        out.append((B, I, k, int(rng.choice(SMS)), bool(rng.integers(0, 2))))
    return out


def _check_k4_plan(B, I, k, sms, cand):
    plan = k4.masked_topk_plan(B, I, k, sms, cand)
    assert plan == k4.masked_topk_plan(B, I, k, sms, cand)  # pure
    R, cluster, span, sub = (plan[key] for key in ("rows_per_block", "cluster", "span", "sub"))
    assert 1 <= cluster <= 8 and R in (1, 2, 4, 8) and (cluster == 1 or R == 1)
    assert plan["grid"] == (cluster, -(-B // R))
    assert 0 < plan["smem"] <= SMEM_LIMIT
    # the C entry's checks (csrc/masked_topk.cu::launch)
    assert span * cluster >= I > span * (cluster - 1)
    assert sub * (k4.WARPS // R) >= span and span % 4 == 0 and sub % 4 == 0
    need = (0 if cand else 4 * k4.WARPS * -(-sub // 32)) + k4.WARPS * 8 * (k + k4.CAP)
    need += cluster * k4.WARPS * 8 * k if cluster > 1 else 0
    assert plan["smem"] >= need
    # every (row, column) pair exactly once: each row's segments tile [0, I)
    rows = {}
    for row, s0, s1 in plan_segments(plan, B, I):
        assert 0 <= row < B and 0 <= s0 < s1 <= I
        rows.setdefault(row, []).append((s0, s1))
    assert sorted(rows) == list(range(B))
    for segs in rows.values():
        segs.sort()
        assert segs[0][0] == 0 and segs[-1][1] == I
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    return plan


@pytest.mark.parametrize("seed", range(8))
def test_masked_topk_plan_covers_every_column_once(seed):
    for shape in _k4_shapes(seed):
        _check_k4_plan(*shape)


@pytest.mark.parametrize("B,I,cand,form", [
    (2048, 4980, False, "dense"),   # the dense path's validation tile
    (32, 4980, False, "cluster"),   # a predict-fallback tile
    (25, 2525, True, "cluster"),    # a `uniform 100` candidate batch
    (1, 12, False, "dense"),        # fewer columns than one warp's step
    (2048, 1_600_000, False, "wide"),  # bitmaps too wide for one warp a row
])
def test_masked_topk_plan_branches(B, I, cand, form):
    """Each branch of the plan at the main path's shapes: whole rows at 8
    rows a block (one warp a row), a row split over a cluster filling the
    SMs, and fewer rows a block, more warps a row, where a warp's bitmap of
    a whole row would not fit."""
    plan = _check_k4_plan(B, I, 10, 132, cand)
    if form == "dense":
        assert plan["cluster"] == 1 and plan["rows_per_block"] == 8
    elif form == "cluster":
        assert plan["cluster"] > 1 and B * plan["cluster"] >= 75
    else:
        assert plan["cluster"] == 1 and plan["rows_per_block"] < 8


def test_masked_topk_plan_rejects():
    with pytest.raises(ValueError):
        k4.masked_topk_plan(10, 20_000_000, 10, 132)  # no block holds the row's bitmap
    with pytest.raises(ValueError):
        k4.masked_topk_plan(10, 50, 65, 132)


def _b13_shapes(seed, n=30):
    rng = np.random.default_rng(100 + seed)
    out = []
    for _ in range(n):
        B = int(rng.choice([1, 40, 63, 64, 65, 129, 256, 2048, int(rng.integers(1, 9000))]))
        I = int(rng.choice([1, 10, 90, 3000, 40_001, 1_100_001, int(rng.integers(1, 2_000_000))]))
        D = int(rng.choice([8, 16, 20, 24, 64, 100, 136, 256]))
        k = int(rng.integers(1, min(64, I) + 1))
        out.append((B, I, D, k, int(rng.choice(SMS))))
    return out


def _check_b13_plan(B, I, D, k, sms):
    plan = b13.streaming_topk_bf16_plan(B, I, D, k, sms)
    assert plan == b13.streaming_topk_bf16_plan(B, I, D, k, sms)  # pure
    wgs, rows, span, n_ranges = plan["wgs"], plan["rows"], plan["span"], plan["n_ranges"]
    assert wgs in (2, 4) and rows == 64 * wgs
    assert plan["smem"] == b13.b13_smem_bytes(wgs, plan["boxes"], plan["stages"], k) <= SMEM_LIMIT
    assert plan["boxes"] == -(-D // 64) and plan["stages"] >= max(4, plan["boxes"])
    assert plan["tma"] == (D % 8 == 0)
    # the C entry's checks (csrc/streaming_topk.cu::streaming_topk_16)
    assert span % 64 == 0 and span * n_ranges >= I > span * (n_ranges - 1)
    assert 1 <= plan["grid"] <= sms and plan["row_blocks"] == -(-B // rows)
    # every (row block, item range) once; ranges disjoint, in order, over [0, I)
    work = b13_plan_work(plan, B, I)
    pairs = [(r, g) for _, r, g in work]
    assert len(pairs) == len(set(pairs)) == plan["row_blocks"] * n_ranges
    ranges = sorted({g for _, _, g in work})
    assert ranges[0][0] == 0 and ranges[-1][1] == I
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    row_spans = sorted({r for _, r, _ in work})
    assert row_spans[0][0] == 0 and row_spans[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(row_spans, row_spans[1:]))
    # the blocks that run together (the first of each block's walk) read as
    # few ranges as the row blocks allow: the row block varies fastest
    first = {}
    for j, _, g in work:
        first.setdefault(j, g)
    assert len(set(first.values())) == -(-len(first) // plan["row_blocks"])
    return plan


@pytest.mark.parametrize("seed", range(8))
def test_b13_plan_covers_every_pair_once(seed):
    for shape in _b13_shapes(seed):
        _check_b13_plan(*shape)


def test_b13_plan_main_path():
    """Phase 2's shape ([2,048 x 64] against 1,100,001 items, k 10, 132
    SMs): four consumer warpgroups (256 rows, so every item tile fetched
    serves 256 users), one long range per block, TMA staging, the table read
    from L2 once per row block."""
    plan = _check_b13_plan(2048, 1_100_001, 64, 10, 132)
    assert plan["wgs"] == 4 and plan["row_blocks"] == 8 and plan["grid"] <= 132
    assert plan["n_ranges"] * plan["row_blocks"] == plan["grid"]
    assert plan["tma"] and plan["l2_bytes"] == 8 * 1_100_001 * 64 * 2


@pytest.mark.parametrize("D,k,wgs", [(256, 64, 2), (136, 10, 4), (256, 10, 2), (24, 64, 2)])
def test_b13_plan_narrows_where_memory_asks(D, k, wgs):
    """Wide rows or long lists leave room for two consumer warpgroups only."""
    assert _check_b13_plan(70, 40_001, D, k, 132)["wgs"] == wgs


def test_b13_plan_rejects():
    with pytest.raises(ValueError):
        b13.streaming_topk_bf16_plan(10, 100, 257, 10, 132)
    with pytest.raises(ValueError):
        b13.streaming_topk_bf16_plan(10, 5, 64, 6, 132)
