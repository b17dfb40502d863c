"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path's shapes do not reach: every ``masked_topk``
template (k up to 64), a row too wide for static shared memory, fewer
unmasked items than k, swap-or-not grids taller than one launch's grid,
history widths with and without 16-byte loads, embedding widths that are
not a multiple of the warp; every ``streaming_topk`` template at the
catalog's 1,100,001 items, a history row spanning many item ranges and
user blocks smaller than the kernel's row block; ``sparse_adam`` with every
id on one row, more ids than rows, and odd widths; ``rank_sum`` with ties
everywhere, history, masked positives, rows without positives and rows
longer than its shared-memory chunk; the NATR attention's forward, backward
and full-sort forms at every kernel width, with empty and single-slot
histories, in both overlap modes; ``streaming_topk``'s tensor-core edges
(D of 8 to 256, k of 1 to 64, partial row blocks and item tiles, a row
masked down to k items); the anchor table and the pair grid at every
kernel width; DTCDR's rating-vector product (B11) with empty rows, rows of
many pieces, repeated ids and widths above one 128-column slice, its
backward twice within its tolerance; the candidate top-k (B10) and the
candidate form of ``rank_sum`` with fewer candidates than k, fully padded
rows and ties; the streaming evaluator's metrics against the dense path's
for CMF on real-valued factors. Plus the entry point on the card, on the
dense path, on the catalog path (sparse optimizer, streaming evaluation),
for BiTGCF, for NATR with GAUC, for DTCDR in the candidate and labeled
eval modes, and for DCDCSR, EMCDR (both forms) and SSCDR. DCDCSR's benchmark
top-k (B12) at every list width (k of 1 to 32), D not a multiple of 4 and
above one 64-column chunk, fewer overlapped rows than one staged tile, more
column splits than the card needs, all-zero rows (ties: ids 0..k-1) and NaN
where ``sn + t_pop`` is 0, and two runs bit-equal.

Marked ``cuda``; without a card every test skips. On the card (where jax is
not installed, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from recbole_cdr_tpu_torch import ops
from recbole_cdr_tpu_torch.ops import benchmark_topk as b12
from recbole_cdr_tpu_torch.ops import candidate_topk as b10
from recbole_cdr_tpu_torch.ops import gather_dot as k1
from recbole_cdr_tpu_torch.ops import graph_layer as b8
from recbole_cdr_tpu_torch.ops import masked_topk as k4
from recbole_cdr_tpu_torch.ops import natr_attention as b9
from recbole_cdr_tpu_torch.ops import neg_sampler as k2
from recbole_cdr_tpu_torch.ops import rank_sum as b7
from recbole_cdr_tpu_torch.ops import rating_vector as b11
from recbole_cdr_tpu_torch.ops import shuffle as k3
from recbole_cdr_tpu_torch.ops import sparse_adam as b6
from recbole_cdr_tpu_torch.ops import topk as b5

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _ints(lo, hi, shape, gen):
    return torch.randint(lo, hi, shape, dtype=torch.int32, device="cuda", generator=gen)


@pytest.mark.parametrize("B,I,k", [(64, 5001, 10), (33, 700, 32), (17, 300, 50),
                                   (8, 600_000, 10), (5, 12, 10)])
def test_masked_topk_matches_plain(gen, B, I, k):
    scores = torch.round(torch.randn(B, I, device="cuda", generator=gen) * 4) / 4  # ties
    counts = torch.randint(0, min(40, I), (B,), device="cuda", generator=gen)
    counts[0] = I - 3  # fewer than k unmasked items: masked ties decide
    row_ptr = torch.zeros(B + 1, dtype=torch.int32, device="cuda")
    row_ptr[1:] = torch.cumsum(counts, 0)
    items = torch.cat([torch.randperm(I, device="cuda", generator=gen)[:c]
                       for c in counts.tolist()]).to(torch.int32)
    got = k4.masked_topk(scores, row_ptr, items, k)
    torch.cuda.synchronize()
    assert torch.equal(got, k4.masked_topk_plain(scores, row_ptr, items, k))


@pytest.mark.parametrize("R,L,n,per_row", [(49, 4096, 200_000, False), (49, 4096, 150_000, True),
                                           (3, 5, 1, False), (70_000, 3, 1000, True)])
def test_swap_or_not_matches_plain(gen, R, L, n, per_row):
    x = _ints(0, max(n, 1), (R, L), gen)
    K = R if per_row else 1
    keys = _ints(0, max(n, 1), (K, 64), gen)
    salts = _ints(-2 ** 31, 2 ** 31, (K, 64), gen)
    got = k3.swap_or_not(x, n, keys, salts)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.swap_or_not_plain(x, n, keys, salts))


@pytest.mark.parametrize("H,ranges,neg_num", [(400, ((1, 2000), (5000, 6000)), 1),
                                              (37, ((1, 30),), 2), (250, ((7, 5000),), 1)])
def test_neg_sampler_matches_plain(gen, H, ranges, neg_num):
    n_users = 4000
    hi = ranges[-1][0] + ranges[-1][1]
    hist = _ints(0, hi, (n_users, H), gen)
    uids = _ints(0, n_users, (30_000,), gen)
    base = _ints(-2 ** 31, 2 ** 31, (30_000 * neg_num,), gen)
    got = k2.sample_negatives(base, uids, hist, ranges, neg_num)
    torch.cuda.synchronize()
    assert torch.equal(got, k2.sample_negatives_plain(base, uids, hist, ranges, neg_num))


@pytest.mark.parametrize("D", [64, 48, 100])
def test_gather_dot_matches_plain(gen, D):
    U = torch.randn(3000, D, device="cuda", generator=gen)
    I = torch.randn(900, D, device="cuda", generator=gen)
    u = _ints(0, 3000, (20_000,), gen)
    i = _ints(0, 900, (20_000,), gen)
    g = torch.randn(20_000, device="cuda", generator=gen)
    torch.testing.assert_close(k1.gather_dot_forward(U, I, u, i), k1.gather_dot_plain(U, I, u, i),
                               rtol=1e-5, atol=1e-4)
    dU, dI = k1.gather_dot_backward(U, I, u, i, g)
    pU, pI = k1.gather_dot_backward_plain(U, I, u, i, g)
    # atomics add in a run-dependent order
    torch.testing.assert_close(dU, pU, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(dI, pI, rtol=1e-5, atol=1e-3)


def _csr(hist):
    row_ptr = torch.zeros(len(hist) + 1, dtype=torch.int32, device="cuda")
    row_ptr[1:] = torch.cumsum(torch.tensor([len(h) for h in hist], device="cuda"), 0)
    return row_ptr, torch.cat(hist).to(torch.int32)


@pytest.mark.parametrize("B,I,D,k", [(40, 1_100_001, 64, 10), (5, 1_100_001, 64, 64),
                                     (33, 20_000, 64, 32), (70, 9000, 17, 16), (3, 70, 8, 64)])
def test_streaming_topk_matches_plain(gen, B, I, D, k):
    """Integer-valued factors: every score is exact whatever the sum order,
    ties are everywhere, and the ids must equal the plain version's. Row 0's
    history spans many item tiles and ranges; row 1 masks all but 3
    items, so masked ties decide its top-k."""
    U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).float()
    T = torch.randint(-3, 4, (I, D), device="cuda", generator=gen).float()
    hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
            for c in torch.randint(0, 50, (B,), generator=torch.Generator().manual_seed(B))]
    hist[0] = torch.randperm(I, device="cuda", generator=gen)[:min(I - 1, 20_000)]
    if B > 1:
        hist[1] = torch.randperm(I, device="cuda", generator=gen)[:I - 3]
    row_ptr, items = _csr(hist)
    got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
    torch.cuda.synchronize()
    want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s, want_s)


def test_streaming_topk_float_scores_within_tolerance(gen):
    """Normal factors: the kernel and torch.matmul add in different orders,
    so scores agree within 1e-4 and ids wherever neighbours differ by more."""
    U = torch.randn(64, 64, device="cuda", generator=gen)
    T = torch.randn(300_001, 64, device="cuda", generator=gen)
    row_ptr, items = _csr([torch.randperm(300_001, device="cuda", generator=gen)[:30]
                           for _ in range(64)])
    got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, 10)
    want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, 10)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-4)
    gap = torch.diff(want_s, dim=1).abs()
    clear = torch.ones_like(want_i, dtype=torch.bool)
    clear[:, 1:] &= gap > 1e-4
    clear[:, :-1] &= gap > 1e-4
    assert torch.equal(got_i[clear], want_i[clear])


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("D", [8, 17, 32, 128, 256])
def test_streaming_topk_tensor_core_edges(gen, D, k):
    """The tensor-core kernel's edges, at 70 rows (not a multiple of its
    64-row block): an item axis smaller than one 128-item tile and one of
    313 tiles whose last is partial; row 2 masked down to exactly k items;
    row 3's history inside the last, partial tile. Integer-valued factors
    score exactly, so ids and scores equal the plain version's; normal
    factors score within 1e-4 + 1e-5 |s| (chip_smoke.py's B5_TOL), their
    ids equal wherever neighbouring scores differ by more."""
    B = 70
    for I in (100, 40_001):
        hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
                for c in torch.randint(0, 30, (B,), generator=torch.Generator().manual_seed(D))]
        hist[2] = torch.randperm(I - 1, device="cuda", generator=gen)[:I - 1 - k] + 1
        last = I - I % 128 if I % 128 else I - 128
        hist[3] = torch.arange(max(last, 1), I, 2, device="cuda")
        row_ptr, items = _csr(hist)
        U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).float()
        T = torch.randint(-3, 4, (I, D), device="cuda", generator=gen).float()
        got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
        torch.cuda.synchronize()
        want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
        assert torch.equal(got_i, want_i), (I, D, k)
        assert torch.equal(got_s, want_s), (I, D, k)
        assert bool((got_s[2] > torch.finfo(torch.float32).min).all())  # its k unmasked items
        U, T = torch.randn(B, D, device="cuda", generator=gen), torch.randn(I, D, device="cuda", generator=gen)
        got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
        want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
        tol = 1e-4 + 1e-5 * want_s.abs()
        assert bool(((got_s - want_s).abs() <= tol).all()), (I, D, k)
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        clear = torch.ones_like(want_i, dtype=torch.bool)
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        assert torch.equal(got_i[clear], want_i[clear]), (I, D, k)


@pytest.mark.parametrize("N,D,R,kind", [(1_400_000, 64, 32_768, "random"), (1000, 64, 5000, "random"),
                                         (300, 33, 4096, "one_row"), (77, 65, 200, "random"),
                                         (1000, 1, 999, "unique")])
def test_sparse_adam_matches_plain(gen, N, D, R, kind):
    """Three steps on one scratch. Rows touched once must match the plain
    version exactly; coalesced rows add with atomics in a run-dependent
    order, within atol 1e-6 and rtol 1e-5 (rows touched up to ~100 times).
    The float32 sum of n terms has a relative error near sqrt(n) eps times
    sum|g| / |sum g|, about 2e-4 at the one-row case's n = 4096 normal
    terms, so that case is held to rtol 1e-3."""
    p = torch.randn(N, D, device="cuda", generator=gen)
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    pp, pmu, pnu = p.clone(), mu.clone(), nu.clone()
    firstpos = b6.first_position_scratch(N, "cuda")
    for c in range(1, 4):
        ids = {"random": lambda: _ints(0, N, (R,), gen),
               "one_row": lambda: torch.full((R,), 7, dtype=torch.int32, device="cuda"),
               "unique": lambda: torch.randperm(N, device="cuda", generator=gen)[:R].int()}[kind]()
        g = torch.randn(R, D, device="cuda", generator=gen)
        step = b6.adam_step_size(1e-3, 0.9, 0.999, c)
        b6.sparse_adam(p, mu, nu, g, ids, step, firstpos=firstpos)
        b6.sparse_adam_plain(pp, pmu, pnu, g, ids, step, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
        for got, want in ((p, pp), (mu, pmu), (nu, pnu)):
            torch.testing.assert_close(got, want, rtol=1e-3 if kind == "one_row" else 1e-5,
                                       atol=1e-6)
        if kind == "unique":
            assert torch.equal(p, pp) and torch.equal(mu, pmu) and torch.equal(nu, pnu)
    assert bool((firstpos == b6.INT32_MAX).all())  # the scratch is left ready


def _random_csr(N, nnz, gen):
    """A random non-symmetric [N, N] CSR and its transpose's CSR: row 0 has
    no nonzero, row 1 (and column 1) exactly one, rows 2 and 3 (and columns
    2 and 3) 64 + 1 and 5,000 more than the rest, so that the kernel splits
    them into several pieces; duplicates allowed."""
    rows = _ints(0, N, (nnz,), gen).long()
    cols = _ints(0, N, (nnz,), gen).long()
    if N > 3:
        keep = (rows != 0) & (rows != 1) & (cols != 1)
        extra = [torch.full((n,), r, device="cuda") for r, n in ((2, 65), (3, 5000))]
        extra_cols = _ints(4, N, (5065,), gen).long()
        rows = torch.cat([rows[keep], torch.tensor([1, 2], device="cuda"), *extra, extra_cols])
        cols = torch.cat([cols[keep], torch.tensor([N - 1, 1], device="cuda"), extra_cols,
                          *extra])
    vals = torch.randn(rows.shape[0], device="cuda", generator=gen)

    def csr(r, c):
        order = torch.argsort(r * N + c)
        row_ptr = torch.zeros(N + 1, dtype=torch.int32, device="cuda")
        row_ptr[1:] = torch.cumsum(torch.bincount(r, minlength=N), 0)
        return b8.make_csr(row_ptr, c[order].int(), vals[order])

    return csr(rows, cols), csr(cols, rows)


def _close_to_exact(got, exact, absum, what):
    """|got - exact| <= 1e-6 + 2e-5 * absum + 1e-6 * |exact| per element:
    float32 sums of n terms in any order are off by at most ~n * eps *
    sum|terms| from the exact sum; the kernel's chains are at most 64
    nonzeros plus, for a row of several pieces, one sum over its pieces
    (<= 79 here); the epilogue rounds once more."""
    err = (got.double() - exact).abs()
    bad = err > 1e-6 + 2e-5 * absum + 1e-6 * exact.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} elements out of tolerance, max error "
        f"{float(err.max()):.3g}, rows {torch.nonzero(bad)[:5, 0].tolist()}")


@pytest.mark.parametrize("N,nnz,D,drop", [(53_002, 1_000_000, 64, 0.3), (3000, 40_000, 48, 0.0),
                                          (3000, 40_000, 192, 0.3), (1, 1, 64, 0.3),
                                          (500, 4000, 37, 0.3), (500, 4000, 64, 0.0)])
def test_graph_layer_matches_plain(gen, N, nnz, D, drop):
    """Forward and backward against the plain version run in float64 on the
    same inputs, within ``_close_to_exact``'s bound, and two kernel runs
    bit-equal (no atomics)."""
    csr, csr_t = _random_csr(N, nnz, gen)
    x = torch.randn(N, D, device="cuda", generator=gen)
    g = torch.randn(N, D, device="cuda", generator=gen)
    bits = _ints(-2 ** 31, 2 ** 31, (N, D), gen) if drop else None
    keep = 1.0 - drop
    new, side = b8.graph_layer_forward(csr, x, bits, keep)
    gx = b8.graph_layer_backward(csr_t, x, side, bits, keep, g)
    torch.cuda.synchronize()

    def f64(m):
        return m._replace(val=m.val.double())

    e_new, e_side = b8.graph_layer_forward_plain(f64(csr), x.double(), bits, keep)
    absum = b8._spmm_plain(f64(csr)._replace(val=csr.val.double().abs()), x.double().abs())
    _close_to_exact(side, e_side, absum, "side")
    # new = x + side + x * side (/ keep): the error of side, scaled by |1 + x| / keep
    _close_to_exact(new, e_new, absum * (1 + x.double().abs()) / keep + 1e-6, "new")
    gp = b8._dropped_grad(g.double(), bits, keep)
    e_gx = b8.graph_layer_backward_plain(f64(csr_t), x.double(), side.double(), bits, keep,
                                         g.double())
    absum_t = b8._spmm_plain(f64(csr_t)._replace(val=csr_t.val.double().abs()),
                             (gp + gp * x.double()).abs())
    _close_to_exact(gx, e_gx, absum_t + 1e-6, "gx")
    new2, side2 = b8.graph_layer_forward(csr, x, bits, keep)
    assert torch.equal(new, new2) and torch.equal(side, side2)
    assert torch.equal(gx, b8.graph_layer_backward(csr_t, x, side, bits, keep, g))
    if N > 3:  # the empty row: side 0; rows of several pieces on both sides
        assert bool((side[0] == 0).all())
        assert csr.heavy_row.shape[0] >= 2 and csr_t.heavy_row.shape[0] >= 2


@pytest.mark.parametrize("B,I,P,integer", [(64, 5001, 25, True), (64, 5001, 25, False),
                                         (7, 70_000, 3, True), (3, 10, 40, True)])
def test_rank_sum_matches_plain(gen, B, I, P, integer):
    """Exactly equal to the plain version, and run to run: the counts are
    integers. Row 0 has no positives, row 1 a positive inside its history
    (holding -inf) and one on PAD; I = 70,000 spans several chunks."""
    if integer:
        scores = torch.randint(-3, 4, (B, I), device="cuda", generator=gen).float()
    else:
        scores = torch.randn(B, I, device="cuda", generator=gen)
    scores[torch.rand(B, I, device="cuda", generator=gen) < 0.01] = -math.inf
    hist = [torch.randint(0, I, (int(c),), device="cuda", generator=gen)
            for c in torch.randint(0, max(I // 8, 2), (B,), generator=torch.Generator().manual_seed(I))]
    hist[1] = torch.cat([hist[1], torch.tensor([5], device="cuda")])
    row_ptr, items = _csr(hist)
    pos = _ints(0, I, (B, P), gen)
    pmask = torch.rand(B, P, device="cuda", generator=gen) < 0.7
    pmask[0] = False
    pos[1, 0], pmask[1, 0], scores[1, 5] = 5, True, -math.inf
    pos[1, -1], pmask[1, -1] = 0, True
    got = b7.rank_sum(scores, row_ptr, items, pos, pmask)
    torch.cuda.synchronize()
    assert torch.equal(got, b7.rank_sum_plain(scores, row_ptr, items, pos, pmask))
    assert torch.equal(got, b7.rank_sum(scores, row_ptr, items, pos, pmask))
    assert float(got[0]) == 0.0


def _natr_inputs(gen, D, H, N, n_anchor_ids, A):
    """A random history matrix [n_anchor_ids, H] over a source table [N, D]
    with lengths 0 to H (anchor 0 and anchor 1 empty, anchor 2 one slot,
    anchor 3 full), A anchors drawn from it (the four first), and weights."""
    ids = _ints(0, N, (n_anchor_ids, H), gen)
    lens = torch.randint(0, H + 1, (n_anchor_ids,), device="cuda", generator=gen)
    lens[:4] = torch.tensor([0, 0, 1, H])
    mask = torch.arange(H, device="cuda")[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    hist = b9.History(0.3 * torch.randn(N, D, device="cuda", generator=gen), ids, mask)
    anchors = _ints(0, n_anchor_ids, (A,), gen)
    anchors[:4] = torch.arange(4, dtype=torch.int32)
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device="cuda", generator=gen)
    w = b9.Weights(rnd(D, D, scale=0.2), rnd(D, scale=0.1), rnd(D, 1, scale=0.3),
                   rnd(1, scale=0.1), rnd(D, 1, scale=0.3), rnd(1, scale=0.1))
    return hist, anchors, w


def _natr_close(got, want, rtol, what):
    """|got - want| <= 1e-5 + rtol * max|want|, as chip_smoke.py's B9_TOL."""
    err = float((got - want).abs().max())
    assert err <= 1e-5 + rtol * float(want.abs().max()), f"{what}: error {err}"


@pytest.mark.parametrize("D,H,A", [(64, 50, 8192), (64, 1, 300), (32, 70, 1000),
                                   (128, 100, 500)])
def test_natr_attention_matches_plain(gen, D, H, A):
    hist, anchors, w = _natr_inputs(gen, D, H, 5000, 3000, A)
    pu = 0.3 * torch.randn(A, D, device="cuda", generator=gen)
    q = 0.3 * torch.randn(A, D, device="cuda", generator=gen)
    g = torch.randn(A, device="cuda", generator=gen)
    got = b9.natr_attention_forward(hist, anchors, pu, q, w)
    torch.cuda.synchronize()
    _natr_close(got, b9.natr_attention_forward_plain(hist, anchors, pu, q, w), 1e-4, "forward")
    assert torch.equal(got, b9.natr_attention_forward(hist, anchors, pu, q, w))
    grads = b9.natr_attention_backward(hist, anchors, pu, q, w, g)
    torch.cuda.synchronize()
    plain = b9.natr_attention_backward_plain(hist, anchors, pu, q, w, g)
    names = ("dpu", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da")
    for name, x, y in zip(names, grads, plain):
        assert x.shape == y.shape, name
        if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
            assert float(x.abs().max()) <= 1e-5
        else:
            _natr_close(x, y, 1e-3, name)
    again = b9.natr_attention_backward(hist, anchors, pu, q, w, g)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("anchor_is_row", [True, False])
def test_natr_full_sort_matches_plain(gen, anchor_is_row):
    """A predict-fallback tile: 32 users x 8,192 items, the anchors on the
    rows (overlap_items) or on the columns (overlap_users)."""
    D, H = 64, 50
    n_anchor = 32 if anchor_is_row else 8192
    hist, _, w = _natr_inputs(gen, D, H, 5000, 9000, 4)
    anchors = _ints(0, 9000, (n_anchor,), gen)
    anchors[:2] = torch.tensor([0, 1], dtype=torch.int32)  # empty histories
    pu = 0.3 * torch.randn(n_anchor, D, device="cuda", generator=gen)
    q = 0.3 * torch.randn(8192 if anchor_is_row else 32, D, device="cuda", generator=gen)
    got = b9.natr_full_sort(hist, anchors, pu, q, w, anchor_is_row)
    torch.cuda.synchronize()
    assert got.shape == (32, 8192)
    _natr_close(got, b9.natr_full_sort_plain(hist, anchors, pu, q, w, anchor_is_row), 1e-4,
                "full-sort")
    assert torch.equal(got, b9.natr_full_sort(hist, anchors, pu, q, w, anchor_is_row))


@pytest.mark.parametrize("anchor_is_row", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_natr_pair_grid_matches_plain(gen, D, anchor_is_row):
    """The anchor table (every anchor row at once) and the pair grid of a
    [33 users x 1,001 items] tile: neither side a multiple of the grid's
    8 x 32 block, the anchors on the rows or on the columns. The table
    within 1e-5 + 1e-4 max of the plain anchor stage, the grid within
    1e-6 + 1e-4 max of the one-call plain full-sort (chip_smoke.py's
    B9_TOL), and both bit-equal from run to run."""
    H, n_users, n_items = 50, 33, 1001
    n_anchor = n_users if anchor_is_row else n_items
    hist, _, w = _natr_inputs(gen, D, H, 5000, 9000, 4)
    table_pu = 0.3 * torch.randn(9000, D, device="cuda", generator=gen)
    every = torch.arange(9000, dtype=torch.int32, device="cuda")
    table = b9.natr_anchor_table(hist, every, table_pu, w)
    torch.cuda.synchronize()
    _natr_close(table, b9.anchor_plain(hist, every, table_pu, w), 1e-4, "anchor table")
    assert torch.equal(table, b9.natr_anchor_table(hist, every, table_pu, w))
    anchors = _ints(0, 9000, (n_anchor,), gen)
    anchors[:2] = torch.tensor([0, 1], dtype=torch.int32)  # empty histories
    pu = table_pu[anchors.long()]
    q = 0.3 * torch.randn(n_items if anchor_is_row else n_users, D, device="cuda", generator=gen)
    got = b9.natr_pair_grid(table[anchors.long()], pu, q, w, anchor_is_row)
    torch.cuda.synchronize()
    assert got.shape == (n_users, n_items)
    want = b9.natr_full_sort_plain(hist, anchors, pu, q, w, anchor_is_row)
    err = float((got - want).abs().max())
    assert err <= 1e-6 + 1e-4 * float(want.abs().max()), f"pair grid: error {err}"
    assert torch.equal(got, b9.natr_pair_grid(table[anchors.long()], pu, q, w, anchor_is_row))


#: B11 tolerance per element, |kernel - plain| <= ATOL + RTOL * the sum of
#: the absolute values of the element's terms (chip_smoke.py's B11_TOL): the
#: kernel and index_add_ add the terms in different orders, with atomics
B11_TOL = (1e-6, 2 ** -18)


def _b11_close(got, want, absum, what):
    diff = (got - want).abs()
    assert bool((diff <= B11_TOL[0] + B11_TOL[1] * absum).all()), \
        f"{what}: error {float(diff.max())}"


@pytest.mark.parametrize("R,N,D,B", [(3000, 27_800, 64, 16_384), (500, 1000, 48, 777),
                                     (40, 300, 130, 100)])
def test_rating_vector_matches_plain(gen, R, N, D, B):
    """Row 0 empty, row 1 of 5,000 entries (157 pieces), the rest of 0 to
    200; ids repeat (the first 64 all row 1, others drawn from 50 rows);
    an id whose row is empty among them."""
    lens = torch.randint(0, 200, (R,), generator=torch.Generator().manual_seed(R))
    lens[0], lens[1] = 0, min(5000, N - 1)
    rows = [torch.randperm(N - 1, generator=torch.Generator().manual_seed(r))[:int(c)] + 1
            for r, c in enumerate(lens)]
    ptr, cols = b11.history_csr(torch.repeat_interleave(torch.arange(R), lens).numpy(),
                                torch.cat(rows).numpy(), R)
    csr = b11.HistoryCSR(torch.from_numpy(ptr).cuda(), torch.from_numpy(cols).cuda())
    ids = _ints(0, min(R, 50), (B,), gen)
    ids[:64], ids[64] = 1, 0
    table = torch.randn(N, D, device="cuda", generator=gen)
    g = torch.randn(B, D, device="cuda", generator=gen)
    got = b11.rating_vector_forward(csr, table, ids)
    torch.cuda.synchronize()
    _b11_close(got, b11.rating_vector_plain(csr, table, ids),
               b11.rating_vector_plain(csr, table.abs(), ids), "forward")
    assert bool((got[64] == 0).all()) and torch.equal(got[0], got[63])
    dt = b11.rating_vector_backward(csr, N, ids, g)
    torch.cuda.synchronize()
    want = b11.rating_vector_backward_plain(csr, N, ids, g)
    absum = b11.rating_vector_backward_plain(csr, N, ids, g.abs())
    _b11_close(dt, want, absum, "backward")
    _b11_close(b11.rating_vector_backward(csr, N, ids, g), want, absum, "backward, second run")
    t = table.clone().requires_grad_()  # through autograd, both directions
    b11.rating_vector(csr, t, ids).backward(g)
    _b11_close(t.grad, want, absum, "autograd")


@pytest.mark.parametrize("B,C,k", [(25, 2525, 10), (40, 7, 7), (3, 1, 1), (64, 300, 64)])
def test_candidate_topk_and_rank_sum_match_plain(gen, B, C, k):
    """Integer scores (ties everywhere); row 0 fully padded, row 1 with
    fewer candidates than 10, the rest padded at random lengths; positives
    first in each row, so column 0 is one. B10 and the candidate rank sums
    exactly equal to their plain versions, and run to run."""
    scores = torch.randint(-3, 4, (B, C), device="cuda", generator=gen).float()
    lens = torch.randint(1, C + 1, (B,), device="cuda", generator=gen)
    lens[0] = 0
    if B > 1:
        lens[1] = min(C, 5)
    cand = torch.arange(C, device="cuda")[None, :] < lens[:, None]
    n_pos = torch.minimum(torch.randint(1, 26, (B,), device="cuda", generator=gen), lens)
    pos = torch.arange(C, device="cuda")[None, :] < n_pos[:, None]
    got = b10.candidate_topk(scores, cand, k)
    torch.cuda.synchronize()
    assert torch.equal(got, b10.candidate_topk_plain(scores, cand, k))
    rs = b7.rank_sum_candidates(scores, cand, pos)
    torch.cuda.synchronize()
    assert torch.equal(rs, b7.rank_sum_candidates_plain(scores, cand, pos))
    assert torch.equal(rs, b7.rank_sum_candidates(scores, cand, pos))
    assert float(rs[0]) == 0.0
    normal = torch.randn(B, C, device="cuda", generator=gen)
    assert torch.equal(b10.candidate_topk(normal, cand, k), b10.candidate_topk_plain(normal, cand, k))
    assert torch.equal(b7.rank_sum_candidates(normal, cand, pos),
                       b7.rank_sum_candidates_plain(normal, cand, pos))


def test_streaming_and_dense_metrics_agree(gen):
    """CMF on the bundled pair with real-valued (normal) factors: the
    streaming path (B5 in 3xTF32) and the dense path (float32 matmul, K4)
    give the same metrics; the top-k ids agree wherever the dense scores of
    neighbouring ranks differ by more than B5's tolerance."""
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
    from recbole_cdr_tpu_torch.models.cmf import CMF
    from recbole_cdr_tpu_torch.utils import init_seed

    config = CDRConfig(model="CMF", config_dict={"state": "ERROR", "device": "cuda"},
                       _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    _, _, test_data = data_preparation(config, dataset)
    model = CMF(config, dataset).cuda()
    with torch.no_grad():
        model.user_embedding.normal_(generator=gen)
        model.item_embedding.normal_(generator=gen)
    ev = FullSortEvaluator(config)
    factors = model.full_sort_factors("TARGET")
    dense = ev.evaluate(lambda users: model.full_sort(users), test_data, "cuda")
    stream = ev.evaluate_streaming(factors, test_data, "cuda")
    print(f"dense {dense}\nstreaming {stream}")
    ids_d = ev.topk_ids(lambda users: model.full_sort(users), test_data, "cuda")
    ids_s = ev.streaming_topk_ids(factors, test_data, "cuda")
    uids = torch.as_tensor(test_data.uid_list, device="cuda")
    with torch.no_grad():
        top = torch.gather(model.full_sort(uids), 1, torch.as_tensor(ids_d, device="cuda"))
    gap = torch.diff(top, dim=1).abs() > 1e-4 + 1e-5 * top[:, 1:].abs()
    clear = torch.ones_like(gap[:, :1])
    clear = (torch.cat([clear, gap], 1) & torch.cat([gap, clear], 1)).cpu().numpy()
    assert (ids_d[clear] == ids_s[clear]).all()
    assert dense == stream


def _run_on_the_card(tmp_path, monkeypatch, model="CMF", **extra):
    from recbole_cdr_tpu_torch import run_recbole_cdr

    monkeypatch.chdir(tmp_path)
    ops.reset_launch_counts()
    result = run_recbole_cdr(model=model, config_dict={
        "state": "ERROR", "device": "cuda", "train_epochs": ["BOTH:2"],
        "train_batch_size": 1024, **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    return ops.launch_counts()


def test_run_recbole_cdr_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch)
    slice1 = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
              "masked_topk")
    assert all(counts[k] > 0 for k in slice1), counts
    assert counts["streaming_topk"] == counts["sparse_adam"] == 0, counts


def test_catalog_path_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, phase_optimizer="sparse",
                              streaming_topk_threshold=1)
    path = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
            "streaming_topk", "sparse_adam")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["masked_topk"] == 0, counts


def test_bitgcf_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, model="BiTGCF")
    path = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
            "masked_topk", "graph_layer_forward", "graph_layer_backward")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["streaming_topk"] == counts["sparse_adam"] == 0, counts


def test_natr_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, model="NATR",
                              train_epochs=["SOURCE:1", "TARGET:1"],
                              metrics=["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"])
    path = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
            "masked_topk", "rank_sum", "natr_attention_forward", "natr_attention_backward",
            "natr_anchor_table", "natr_pair_grid")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts


@pytest.mark.parametrize("mode", ["full", "uniform 20", "labeled"])
def test_dtcdr_on_the_card(gen, tmp_path, monkeypatch, mode):
    """DTCDR (DMF) in each eval mode: B11 forward and backward in training,
    the mode's kernels in evaluation (K4 for full-sort, B10 and the
    candidate B7 for candidates, none for labeled), B5, B6, B8 and B9
    never."""
    eval_args = {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "RO",
                 "mode": mode}
    extra = {"base_model": "DMF", "eval_args": eval_args}
    if mode == "labeled":
        extra.update(threshold={"rating": 4}, source_val_interval=None, target_val_interval=None,
                     metrics=["AUC", "MAE", "RMSE", "LogLoss"], valid_metric="AUC")
    else:
        extra["metrics"] = ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]
    counts = _run_on_the_card(tmp_path, monkeypatch, model="DTCDR", **extra)
    path = {"full": ("masked_topk", "rank_sum"),
            "uniform 20": ("candidate_topk", "rank_sum_candidates"), "labeled": ()}[mode]
    path += ("neg_sampler", "swap_or_not", "rating_vector_forward", "rating_vector_backward")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts


@pytest.mark.parametrize("M,n_ov,D,k", [(9000, 2001, 64, 10), (300, 20, 37, 1),
                                        (1000, 500, 130, 17), (70, 33, 8, 32),
                                        (5, 2001, 64, 16)])
def test_benchmark_topk_matches_plain(gen, M, n_ov, D, k):
    """B12 against its plain version: ids exact where the k-th and (k+1)-th
    similarity differ by more than 1e-5 (the all-zero rows: exactly 0..k-1),
    the rows within 1e-5 + 1e-5·|x| there, NaN where ``sn + t_pop`` is 0;
    two runs bit-equal."""
    rest = torch.randn((M, D), generator=gen, device="cuda") * 0.3
    src = torch.randn((n_ov, D), generator=gen, device="cuda") * 0.3
    rest[::3] = 0.0
    s_pop = _ints(0, 5, (n_ov,), gen).float()
    t_pop = _ints(0, 5, (M,), gen).float()
    out, idx, sim = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    out2, idx2, sim2 = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    assert torch.equal(idx, idx2) and torch.equal(sim, sim2)
    assert torch.equal(out.nan_to_num(7.0), out2.nan_to_num(7.0))
    p_out, p_idx, p_sim = b12.benchmark_topk_plain(rest, src, s_pop, t_pop, k)
    zero = (rest == 0).all(1)
    assert (idx[zero] == torch.arange(k, device="cuda")).all()
    srt = torch.sort((rest.double() @ src.double().T), 1, descending=True).values
    clear = (srt[:, k - 1] - srt[:, k] > 1e-5 if n_ov > k
             else torch.ones(M, dtype=torch.bool, device="cuda")) | zero
    assert clear.float().mean() > 0.5
    assert torch.equal(idx[clear].sort(1).values, p_idx[clear].sort(1).values)
    torch.testing.assert_close(sim, p_sim, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[clear], p_out[clear], atol=1e-5, rtol=1e-5, equal_nan=True)
    assert torch.isnan(out).any() == torch.isnan(p_out).any()


@pytest.mark.parametrize("model,extra", [
    ("DCDCSR", {"train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"]}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"], "loss_type": "BPR",
               "latent_factor_model": "BPR"}),
    ("SSCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"]}),
], ids=["DCDCSR", "EMCDR-CE", "EMCDR-BPR", "SSCDR"])
def test_mapping_models_on_the_card(gen, tmp_path, monkeypatch, model, extra):
    """The three mapping models' schedules: K2 and K3 in the device-path
    phases, K4 in evaluation, K1 for the dot-product models, B12 once per
    DCDCSR run; B5 to B11 never."""
    counts = _run_on_the_card(tmp_path, monkeypatch, model=model, **extra)
    path = ("neg_sampler", "swap_or_not", "masked_topk")
    if model != "SSCDR":
        path += ("gather_dot_forward", "gather_dot_backward")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["benchmark_topk"] == (model == "DCDCSR"), counts
    assert all(counts[k] == 0 for k in counts if k not in path + ("benchmark_topk",)), counts
