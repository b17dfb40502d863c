"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path's shapes do not reach: every ``masked_topk``
template (k up to 64), a row too wide for static shared memory, fewer
unmasked items than k, swap-or-not grids taller than one launch's grid,
history widths with and without 16-byte loads, embedding widths that are
not a multiple of the warp; every ``streaming_topk`` template at the
catalog's 1,100,001 items, a history row longer than one chunk's bitmap and
user blocks smaller than the kernel's row block; ``sparse_adam`` with every
id on one row, more ids than rows, and odd widths; ``rank_sum`` with ties
everywhere, history, masked positives, rows without positives and rows
longer than its shared-memory chunk; the NATR attention's forward, backward
and full-sort forms at every kernel width, with empty and single-slot
histories, in both overlap modes. Plus the entry point on the card, on the
dense path, on the catalog path (sparse optimizer, streaming evaluation),
for BiTGCF and for NATR with GAUC.

Marked ``cuda``; without a card every test skips. On the card (where jax is
not installed, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from recbole_cdr_tpu_torch import ops
from recbole_cdr_tpu_torch.ops import gather_dot as k1
from recbole_cdr_tpu_torch.ops import graph_layer as b8
from recbole_cdr_tpu_torch.ops import masked_topk as k4
from recbole_cdr_tpu_torch.ops import natr_attention as b9
from recbole_cdr_tpu_torch.ops import neg_sampler as k2
from recbole_cdr_tpu_torch.ops import rank_sum as b7
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
    history spans more than one 8192-item chunk; row 1 masks all but 3
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
            "natr_full_sort")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts
