"""The launch plan of B7 (``rank_sum_plan``), held on the CPU, and B7's
count by search.

The plan is a plain Python function that the wrapper hands to its C entry;
the kernel derives every block's work from it. Over shapes drawn with a
numpy seed: every (row, column) pair is covered exactly once, as the kernel
walks them; a cluster has at most 8 blocks and fills the SMs on short
tiles; dense tiles keep one block a row; a block's shared memory fits an
H100's 232,448 bytes and matches the C entry's own checks; shapes the
kernel cannot serve raise. B7's kernel counts each element's positives
below and at or below it in the sorted list; that identity is held against
the plain version on ties, NaN and -inf.
"""

import numpy as np
import pytest
import torch

from recbole_cdr_tpu_torch.ops import rank_sum as b7

SMEM_LIMIT = 232_448
SMS = (132, 114, 78, 16, 1)


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------- B7's plan

def rank_sum_spans(plan, B, I):
    """Every block's (row, first column, end column) under a B7 plan, as
    ``csrc/rank_sum.cu`` derives them from ``blockIdx`` (empty spans left
    out)."""
    out = []
    for x in range(plan["grid"][0]):
        for row in range(plan["grid"][1]):
            c0, c1 = x * plan["span"], min(I, (x + 1) * plan["span"])
            if c0 < c1:
                out.append((row, c0, c1))
    return out


def _check_b7_plan(B, I, P, sms, cand):
    plan = b7.rank_sum_plan(B, I, P, sms, cand)
    assert plan == b7.rank_sum_plan(B, I, P, sms, cand)  # pure
    cluster, span, cap = plan["cluster"], plan["span"], plan["cap"]
    assert 1 <= cluster <= 8 and plan["grid"] == (cluster, B)
    assert 0 < plan["smem"] <= SMEM_LIMIT
    # the C entry's checks (csrc/rank_sum.cu::launch)
    assert span * cluster >= I > span * (cluster - 1) and span % 32 == 0
    assert cap >= max(P, 1) and cap & (cap - 1) == 0 and cap < 2 * max(P, 1)
    assert plan["smem"] >= 4 * (cap + (0 if cand else _cdiv(I, 32)))
    if B >= sms:
        assert cluster == 1  # dense: one block a row
    else:
        assert B * cluster >= min(B * 8, sms, B * _cdiv(I, b7.MIN_SPAN))
    # every (row, column) exactly once
    rows = {}
    for row, c0, c1 in rank_sum_spans(plan, B, I):
        rows.setdefault(row, []).append((c0, c1))
    assert sorted(rows) == list(range(B))
    for spans in rows.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == I and len(spans) == cluster
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    return plan


def _b7_shapes(seed, n=40):
    rng = np.random.default_rng(200 + seed)
    out = []
    for _ in range(n):
        B = int(rng.choice([1, 7, 25, 31, 32, 33, 131, 132, 133, 2048,
                            int(rng.integers(1, 5000))]))
        I = int(rng.choice([1, 31, 255, 256, 257, 2525, 4980, 5001, 70_000,
                            int(rng.integers(1, 400_000))]))
        cand = bool(rng.integers(0, 2))
        P = I if cand else int(rng.choice([0, 1, 8, 25, 33, 1600, int(rng.integers(0, 3000))]))
        if cand and I > 32_768:
            I = P = int(rng.integers(1, 32_769))
        out.append((B, I, P, int(rng.choice(SMS)), cand))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_rank_sum_plan_covers_every_column_once(seed):
    for shape in _b7_shapes(seed):
        _check_b7_plan(*shape)


@pytest.mark.parametrize("B,I,P,cand,cluster", [
    (2048, 4980, 50, False, 1),   # the dense path's validation tile
    (133, 5001, 25, False, 1),    # just past the SM count
    (32, 4980, 30, False, 5),     # a predict-fallback tile: 160 blocks
    (7, 4980, 30, False, 8),
    (1, 5001, 1600, False, 8),
    (25, 2525, 2525, True, 6),    # a `uniform 100` candidate batch
    (32, 31, 3, False, 1),        # fewer columns than one block's least span
    (1, 1, 1, True, 1),
])
def test_rank_sum_plan_branches(B, I, P, cand, cluster):
    """Each branch at the main path's shapes and the card tests': one block
    a row on dense tiles, a row over a cluster filling the SMs on short
    ones, one block where a row holds fewer columns than a block's least
    span."""
    assert _check_b7_plan(B, I, P, 132, cand)["cluster"] == cluster


def test_rank_sum_plan_at_the_limits():
    """The candidate form's widest row in one block's shared memory (32,768
    candidates: a 128 KiB sorted list) and the first that does not fit."""
    assert _check_b7_plan(25, 32_768, 32_768, 132, True)["cap"] == 32_768
    with pytest.raises(ValueError):
        b7.rank_sum_plan(25, 32_769, 32_769, 132, cand=True)


@pytest.mark.parametrize("B,I,P,sms", [(10, 2_000_000, 10, 132), (10, 5000, 100_000, 132),
                                       (0, 10, 1, 132), (3, 0, 1, 132), (3, 10, 1, 0)])
def test_rank_sum_plan_rejects(B, I, P, sms):
    with pytest.raises(ValueError):
        b7.rank_sum_plan(B, I, P, sms)


# ------------------------------------------------------ B7's count by search

def _search_rank_sum(scores, row_ptr, items, pos, pos_mask):
    """The kernel's arithmetic in numpy: on the masked row, the valid
    positives' values sorted (NaN left out), and 2 out = n_valid + the sum
    over elements s of #{v < s} + #{v <= s}."""
    s = b7.masked_scores_plain(scores, row_ptr, items).numpy()
    pos, pos_mask = pos.numpy(), pos_mask.numpy()
    out = np.zeros(s.shape[0], np.float32)
    for r in range(s.shape[0]):
        p = pos[r][pos_mask[r] & (pos[r] >= 0) & (pos[r] < s.shape[1])]
        v = s[r, p]
        v = np.sort(v[~np.isnan(v)])
        x = s[r][~np.isnan(s[r])]
        lt = np.searchsorted(v, x, side="left").sum()
        le = np.searchsorted(v, x, side="right").sum()
        out[r] = np.float32((int(lt) + int(le) + len(p)) / 2)
    return torch.from_numpy(out)


@pytest.mark.parametrize("seed", range(3))
def test_rank_sum_count_by_search_equals_plain(seed):
    """Integer scores (ties everywhere), NaN and -inf scores, positives on
    PAD, inside the history and repeated, rows without positives: the identity the kernel counts by equals the plain version
    exactly."""
    rng = np.random.default_rng(seed)
    B, I, P = 9, 300, 40
    scores = rng.integers(-3, 4, (B, I)).astype(np.float32)
    scores[rng.random((B, I)) < 0.02] = np.nan
    scores[rng.random((B, I)) < 0.02] = -np.inf
    lens = rng.integers(0, 60, B)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    items = rng.integers(0, I, int(row_ptr[-1])).astype(np.int32)
    pos = rng.integers(0, I, (B, P)).astype(np.int32)
    pmask = rng.random((B, P)) < 0.6
    pos[0, :3], pmask[0, :3] = [0, items[0] if lens[0] else 5, 7], True
    pos[1, 1] = pos[1, 0]
    pmask[2] = False
    args = [torch.from_numpy(a) for a in (scores, row_ptr, items, pos, pmask)]
    assert torch.equal(_search_rank_sum(*args), b7.rank_sum_plain(*args))



# ------------------------------------------------ B12's screening launch plan

from recbole_cdr_tpu_torch.ops import benchmark_topk as b12  # noqa: E402

#: an SM's shared memory for its blocks, each with 1 KB of its own reserved
SM_SMEM = 233_472


@pytest.mark.parametrize("M,n_ov,k,sms", [
    (1, 1, 1, 1), (64, 64, 1, 132), (65, 65, 17, 114), (10_000, 2000, 10, 132),
    (9000, 2001, 32, 132), (5, 100_000, 16, 132), (100_000, 64, 10, 132), (1, 7, 7, 1),
    (300, 20, 1, 132), (12_000, 4096, 32, 16)])
def test_benchmark_topk_plan_covers_every_column(M, n_ov, k, sms):
    """The plan's ranges: 1 to ``MAX_SPLITS`` of whole tiles, together
    covering every source row, none empty; as many blocks as the SMs hold
    fit their shared memory (and one block an H100's 232,448 bytes)."""
    splits, span = b12.benchmark_topk_plan(M, n_ov, k, sms)
    assert 1 <= splits <= b12.MAX_SPLITS and span % b12.COLS == 0
    assert splits * span >= n_ov > (splits - 1) * span
    assert splits <= _cdiv(n_ov, b12.COLS)
    smem = b12.screen_smem_bytes(k)
    assert smem <= SMEM_LIMIT
    assert b12.blocks_per_sm(k) * (smem + 1024) <= SM_SMEM
    slots, row_blocks = sms * b12.blocks_per_sm(k), _cdiv(M, b12.ROWS)
    if 2 * row_blocks <= slots and _cdiv(n_ov, b12.COLS) >= 2 * b12.MAX_SPLITS:
        assert splits > 1  # few rows: the columns are split
    # no count of ranges gives the SMs less to do by the plan's measure
    def cost(per):
        n = _cdiv(_cdiv(n_ov, b12.COLS), per)
        return (per + b12.RANGE_COST) * max(1.0, row_blocks * n / slots)

    for n in range(1, b12.MAX_SPLITS + 1):
        assert cost(span // b12.COLS) <= cost(_cdiv(_cdiv(n_ov, b12.COLS), n))


def test_benchmark_topk_plan_at_phase8():
    """Phase 8's DCDCSR tables on 132 SMs (8,970 rest rows against 2,001
    overlapped, k 10): its 2,990 rows that hold a value other than 0 take
    six ranges of 6 tiles, 282 blocks in 264 slots (9 tile-costs by the
    plan's measure, where five ranges of 7 take 10); had every row a value,
    two ranges of 16 tiles."""
    assert b12.benchmark_topk_plan(2990, 2001, 10, 132) == (6, 384)
    assert b12.benchmark_topk_plan(8970, 2001, 10, 132) == (2, 1024)


@pytest.mark.parametrize("M,n_ov,k,sms", [(0, 10, 1, 132), (10, 0, 1, 132), (10, 10, 0, 132),
                                          (10, 40, 33, 132), (10, 10, 1, 0)])
def test_benchmark_topk_plan_rejects(M, n_ov, k, sms):
    with pytest.raises(ValueError):
        b12.benchmark_topk_plan(M, n_ov, k, sms)


def _tf32(x):
    """x cut to TF32 as the tensor core reads it (the top 19 bits)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


@pytest.mark.parametrize("D", [8, 37, 64, 130])
def test_screen_error_bounds_3xtf32(D):
    """The screen's bound in torch on the CPU: similarities summed as the
    tensor cores do in 3xTF32 (each operand's TF32 part, its float32 rest
    read as TF32; hi*hi + hi*lo + lo*hi, the terms exact in float32, added
    in float32) lie within ``screen_error`` of the rows' largest |values|
    of the float32 fmaf chain (float64 products and adds rounded to float32
    each step), on normal rows and on rows whose values span 2^-20 to 2^20."""
    rng = np.random.default_rng(D)
    a = rng.normal(size=(40, D)).astype(np.float32)
    b = rng.normal(size=(50, D)).astype(np.float32)
    a[20:] *= np.exp2(rng.integers(-20, 21, size=(20, D))).astype(np.float32)
    b[25:] *= np.exp2(rng.integers(-20, 21, size=(25, D))).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ah, bh = _tf32(ta), _tf32(tb)
    al, bl = _tf32(ta - ah), _tf32(tb - bh)
    s = torch.zeros(40, 50)
    for d in range(D):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            s = s + x[:, d:d + 1] * y[None, :, d]
    f = torch.zeros(40, 50, dtype=torch.float32)
    for d in range(D):
        f = (ta[:, d:d + 1].double() * tb[None, :, d].double() + f.double()).float()
    e = b12.screen_error(D, ta.double().abs().amax(1)[:, None], tb.double().abs().amax(1)[None])
    assert bool(((s.double() - f.double()).abs() <= e).all())
