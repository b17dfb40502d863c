"""The port's kernel modules against the JAX functions they replace, on the
CPU (where each wrapper runs its plain PyTorch version): K2 and K3 bit-exact
with the same random bits, K4 with exact ids under deliberate ties, K1 within
the oracle tolerances of ``tests/test_oracle_equivalence.py`` in each of its
backward's forms, and the tables its backward reads by position."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.evaluator.evaluator import _apply_masks_pairs
from recbole_cdr_tpu.trainer.device_loop import (
    _contiguous_ranges,
    _device_hist,
    _sample_negatives,
    _shuffle_keys,
    _swap_or_not,
)

from recbole_cdr_tpu_torch.ops import launch_counts
from recbole_cdr_tpu_torch.ops.gather_dot import POSITIONS, backward_groups, gather_dot
from recbole_cdr_tpu_torch.ops.masked_topk import masked_topk
from recbole_cdr_tpu_torch.ops.neg_sampler import sample_negatives, sample_negatives_plain
from recbole_cdr_tpu_torch.ops.shuffle import swap_or_not
from recbole_cdr_tpu_torch.trainer import device_loop as torch_loop

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)


def _t(a):
    """numpy -> torch, uint32 bit patterns as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("candidates,H,neg_num", [
    (np.arange(1, 101), 25, 1),                                   # one run
    (np.concatenate([np.arange(1, 40), np.arange(70, 130)]), 37, 2),  # two runs, H % 32 != 0
])
def test_neg_sampler_matches_jax_bit_exact(candidates, H, neg_num):
    rng = np.random.default_rng(0)
    n_users, B = 24, 300
    sentinel = 200
    hist = np.full((n_users, H), sentinel, np.int32)
    for u in range(n_users):
        k = rng.integers(0, H + 1)
        hist[u, :k] = rng.choice(candidates, k, replace=False)
    # user 0 covers every candidate but the first: most slots exhaust all
    # rounds; user 1 covers all of them and forces the round R-1 fallback
    hist = np.concatenate([hist, np.full((n_users, len(candidates)), sentinel, np.int32)], 1)
    hist[0, :len(candidates) - 1] = candidates[1:]
    hist[1, :len(candidates)] = candidates
    uids = rng.integers(0, n_users, B).astype(np.int32)
    uids[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
    ranges = _contiguous_ranges(candidates)
    key = jax.random.PRNGKey(3)
    want = np.asarray(_sample_negatives(
        key, jnp.asarray(uids), jnp.asarray(hist), jnp.asarray(candidates, jnp.int32),
        neg_num, cand_ranges=ranges,
    ))
    bits = jax.random.bits(key, (B * neg_num,), dtype=jnp.uint32)
    got = sample_negatives(_t(bits), _t(uids), _t(hist), ranges, neg_num).numpy()
    np.testing.assert_array_equal(got, want)
    # the fully covered user really took the fallback round
    assert np.isin(got[np.tile(uids, neg_num) == 1], candidates).all()


def _used_ids(seed, n_users, n_items, n_inter):
    """A sampler's used-set (``keys`` = uid * num_items + iid, unique and
    sorted, as ``sampler/sampler.py`` builds it) of random interactions
    with skewed user degrees, users 1 .. n_users - 1."""
    rng = np.random.default_rng(seed)
    uids = rng.zipf(1.5, n_inter) % (n_users - 1) + 1
    iids = rng.integers(1, n_items, n_inter)
    return SimpleNamespace(keys=np.unique(uids * n_items + iids), num_items=n_items)


@pytest.mark.parametrize("cap,neg_num", [(None, 1), (None, 2), (6, 1)])
def test_neg_sampler_loop_lens_match_jax(cap, neg_num):
    """The plain version walking only each row's first ``lens[u]`` entries
    (the device loop's history and lens) equals JAX's ``_sample_negatives``
    comparing the whole padded rows, on the same rows, bits and candidate
    runs; with ``cap`` the heavy users' rows are cut to the cap (their
    lens is the cap)."""
    n_users, n_items = 40, 90
    used = _used_ids(5, n_users, n_items, 900)
    hist, heavy, lens = torch_loop._device_hist(used, n_users, cap)
    want_hist, want_heavy = _device_hist(used, n_users, cap)
    np.testing.assert_array_equal(hist, np.asarray(want_hist))
    np.testing.assert_array_equal(heavy, want_heavy)
    assert (cap is not None) == bool(len(heavy)) and lens.max() == hist.shape[1]
    candidates = np.arange(1, n_items)
    ranges = _contiguous_ranges(candidates)
    uids = np.random.default_rng(6).integers(0, n_users, 500).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(_sample_negatives(key, jnp.asarray(uids), jnp.asarray(hist),
                                        jnp.asarray(candidates, jnp.int32), neg_num,
                                        cand_ranges=ranges))
    bits = _t(jax.random.bits(key, (len(uids) * neg_num,), dtype=jnp.uint32))
    got = sample_negatives_plain(bits, _t(uids), _t(hist), ranges, neg_num,
                                 lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    # junk past lens is ignored: the rows' padding replaced by candidates
    junk = np.where(np.arange(hist.shape[1]) < lens[:, None], hist,
                    np.random.default_rng(7).integers(1, n_items, hist.shape))
    got = sample_negatives(bits, _t(uids), _t(junk.astype(np.int32)), ranges, neg_num,
                           lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [None, 4, 1])
def test_device_hist_lens_count_live_entries(cap):
    """The device loop's ``lens`` is each history row's count of entries
    that are not the padding sentinel (``num_items``), and those entries
    come first in the row."""
    used = _used_ids(11, 25, 60, 400)
    hist, _, lens = torch_loop._device_hist(used, 25, cap)
    assert lens.dtype == np.int32 and lens.shape == (25,)
    live = hist != used.num_items
    np.testing.assert_array_equal(lens, live.sum(1))
    np.testing.assert_array_equal(live, np.arange(hist.shape[1]) < lens[:, None])


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("n,per_row", [(1000, False), (937, True), (1, False)])
def test_swap_or_not_matches_jax_exact(n, per_row):
    R, L = 6, 211
    keys, salts = _shuffle_keys(jax.random.PRNGKey(5), n, (R,) if per_row else ())
    x = np.random.default_rng(1).integers(0, max(n, 1), (R, L)).astype(np.int32)
    if per_row:
        want = _swap_or_not(jnp.asarray(x), n, keys[:, None, :], salts[:, None, :])
    else:
        want = _swap_or_not(jnp.asarray(x), n, keys, salts)
    k, s = _t(keys).reshape(-1, 64), _t(salts).reshape(-1, 64)
    got = swap_or_not(_t(x), n, k, s).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n", [2, 97, 4096])
def test_swap_or_not_is_a_bijection(n):
    keys, salts = _shuffle_keys(jax.random.PRNGKey(n), n)
    out = swap_or_not(torch.arange(n, dtype=torch.int32)[None], n,
                      _t(keys)[None], _t(salts)[None]).numpy()[0]
    assert sorted(out.tolist()) == list(range(n))


# ------------------------------------------------------------------ K4

def test_masked_topk_matches_jax_exact_with_ties():
    rng = np.random.default_rng(2)
    B, I, k = 40, 30, 10
    # quarter-step scores: many exact ties inside every row
    scores = (rng.integers(-6, 7, (B, I)) / 4.0).astype(np.float32)
    lens = rng.integers(0, 8, B)
    lens[3] = I - 4          # fewer than k unmasked items: masked ties decide
    lens[4] = I              # every item masked
    rows = np.repeat(np.arange(B), lens)
    items = np.concatenate([rng.permutation(I)[:n] for n in lens]).astype(np.int32)
    j = _apply_masks_pairs(jnp.asarray(scores), jnp.asarray(rows, jnp.int32),
                           jnp.asarray(items), jnp.ones(len(rows), bool))
    want = np.asarray(jax.lax.top_k(j, k)[1])
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got = masked_topk(_t(scores), _t(row_ptr), _t(items), k).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("form", ["grouped", "positions", "broken"])
def test_gather_dot_matches_cmf_score_and_grads(form):
    """``grouped``: random ids into whole tables; ``positions``: sub-tables
    read by position (the user table's rows shared by two pairs each, BPR's
    user slot); ``broken``: random ids into tables marked as read by
    position, whose backward falls back to the grouped sums."""
    rng = np.random.default_rng(4)
    Nu, Ni = {"grouped": (50, 40), "positions": (150, 300), "broken": (60, 100)}[form]
    U = (rng.standard_normal((Nu, 64)) * 0.1).astype(np.float32)
    I = (rng.standard_normal((Ni, 64)) * 0.1).astype(np.float32)
    if form == "positions":
        u, i = np.arange(300) % Nu, np.arange(300)
    else:
        u, i = rng.integers(0, Nu, 300), rng.integers(0, Ni, 300)
    u, i = u.astype(np.int32), i.astype(np.int32)
    w = rng.standard_normal(300).astype(np.float32)

    def f(p):
        s = jnp.sum(p["U"][u] * p["I"][i], axis=-1)  # CMF._score
        return jnp.sum(s * w), s

    (_, js), jg = jax.value_and_grad(f, has_aux=True)({"U": U, "I": I})
    tU = torch.tensor(U, requires_grad=True)
    tI = torch.tensor(I, requires_grad=True)
    ts = gather_dot(tU, tI, _t(u), _t(i), (form != "grouped",) * 2)
    (ts * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **LOSS_TOL)
    np.testing.assert_allclose(tU.grad.numpy(), np.asarray(jg["U"]), **GRAD_TOL)
    np.testing.assert_allclose(tI.grad.numpy(), np.asarray(jg["I"]), **GRAD_TOL)


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_backward_groups_reads_positions_only_where_promised(slots):
    """K1's backward reads a table by position only where the caller marks
    it and the pairs are a whole multiple of its rows (``slots`` pairs a
    row: 2 is BPR's user slot shared by the positive and the negative);
    any other table gets the grouping of its ids (None on the CPU, whose
    plain version reads the ids)."""
    R = 64
    P = slots * R
    U, I = torch.zeros(R, 8), torch.zeros(P, 8)
    u = (torch.arange(P) % R).int()
    i = torch.arange(P, dtype=torch.int32)
    assert backward_groups(U, I, u, i, (True, True)) == (POSITIONS, POSITIONS)
    assert backward_groups(U, I, u, i, (False, True)) == (None, POSITIONS)
    assert backward_groups(U, I, u, i) == (None, None)
    short = torch.zeros(R + 1, 8)  # P is no multiple of its rows
    assert backward_groups(short, I, u, i, (True, True)) == (None, POSITIONS)


# ------------------------------------------------------------ dispatch

def test_wrappers_run_plain_versions_on_cpu_without_counting():
    """CPU tensors take the plain version (no launch is counted); a device
    with neither version raises instead of falling back."""
    before = launch_counts()
    x = torch.arange(8, dtype=torch.int32)[None]
    keys = torch.zeros((1, 64), dtype=torch.int32)
    swap_or_not(x, 8, keys, keys)
    assert launch_counts() == before
    with pytest.raises(ValueError):
        swap_or_not(x.to("meta"), 8, keys.to("meta"), keys.to("meta"))
    with pytest.raises(ValueError):
        masked_topk(torch.zeros((2, 5), device="meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"),
                    torch.zeros(1, dtype=torch.int32, device="meta"), 2)
