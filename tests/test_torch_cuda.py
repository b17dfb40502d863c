"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path's shapes do not reach: every ``masked_topk``
template (k up to 64), a row too wide for static shared memory, fewer
unmasked items than k, swap-or-not grids taller than one launch's grid,
history widths with and without 16-byte loads, embedding widths that are
not a multiple of the warp; every ``streaming_topk`` template at the
catalog's 1,100,001 items, a history row longer than one chunk's bitmap and
user blocks smaller than the kernel's row block; ``sparse_adam`` with every
id on one row, more ids than rows, and odd widths. Plus the entry point on
the card, on the dense path and on the catalog path (sparse optimizer,
streaming evaluation).

Marked ``cuda``; without a card every test skips. On the card (where jax is
not installed, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from recbole_cdr_tpu_torch import ops
from recbole_cdr_tpu_torch.ops import gather_dot as k1
from recbole_cdr_tpu_torch.ops import masked_topk as k4
from recbole_cdr_tpu_torch.ops import neg_sampler as k2
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


def _run_on_the_card(tmp_path, monkeypatch, **extra):
    from recbole_cdr_tpu_torch import run_recbole_cdr

    monkeypatch.chdir(tmp_path)
    ops.reset_launch_counts()
    result = run_recbole_cdr(model="CMF", config_dict={
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
