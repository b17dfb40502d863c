"""Kernel B5's plain version (``ops/topk.py``) and the port's streaming
evaluator against the JAX package, on the CPU (where the wrapper runs the
plain version).

- The streaming top-k against JAX's ``streaming_topk_with_history`` (history
  as a padded [B, H] matrix) and ``_stream_topk_hist_pairs`` (history as
  item-tile-partitioned pair lists): item axes that are not a multiple of the
  tile, k larger than the tile, rows with fewer than k unmasked items, and
  integer-valued factors whose scores tie everywhere. Every score is then an
  exact float32 value whatever the summation order, so the ids must be equal
  exactly and the scores too.
- The streaming evaluator against the port's dense evaluator and against
  JAX's ``evaluate_streaming`` on the bundled pair (parameters quantized to
  multiples of 1/64 so that both packages' scores are exact): equal ids and
  metrics, and the trainer's routing by ``streaming_topk_threshold``.
- B13 (bf16 factors): the plain version against JAX's
  ``_stream_topk_hist_pairs`` on the same bf16 values within ``B13_TOL``,
  ids equal except at near-ties; dispatch by dtype; and the streaming
  evaluator under ``eval_score_dtype: bfloat16`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.evaluator.evaluator import FullSortEvaluator as JaxEvaluator
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.ops.topk import _stream_topk_hist_pairs, streaming_topk_with_history
from recbole_cdr_tpu.utils import init_seed as jax_init_seed

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.ops import launch_counts, reset_launch_counts
from recbole_cdr_tpu_torch.ops.topk import (
    INT32_MAX,
    sharded_topk_local_plain,
    sharded_topk_merge,
    sharded_topk_merge_plain,
    streaming_topk,
    streaming_topk_bf16,
    streaming_topk_plain,
)
from recbole_cdr_tpu_torch.parallel import make_mesh
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax


def _case(B, I, D, max_hist, seed, heavy_rows=0):
    """Integer-valued factors in {-3..3} and a random CSR history; the first
    ``heavy_rows`` rows mask all but 3 items."""
    rng = np.random.default_rng(seed)
    U = rng.integers(-3, 4, (B, D)).astype(np.float32)
    T = rng.integers(-3, 4, (I, D)).astype(np.float32)
    hist = [rng.choice(I, rng.integers(0, max_hist + 1), replace=False) for _ in range(B)]
    for r in range(heavy_rows):
        hist[r] = rng.permutation(I)[:I - 3]
    row_ptr = np.concatenate([[0], np.cumsum([len(h) for h in hist])]).astype(np.int32)
    items = np.concatenate(hist).astype(np.int32)
    return U, T, hist, row_ptr, items


def _jax_matrix(hist, I):
    H = max(max(len(h) for h in hist), 1)
    m = np.full((len(hist), H), I, np.int32)  # sentinel >= I pads
    for r, h in enumerate(hist):
        m[r, :len(h)] = h
    return m


def _jax_pairs(hist, I, tile):
    """[n_tiles, P] (row, item, valid) pair lists partitioned by item tile."""
    n_tiles = -(-I // tile)
    cells = [[] for _ in range(n_tiles)]
    for r, h in enumerate(hist):
        for it in h:
            cells[it // tile].append((r, it))
    P = max(max(len(c) for c in cells), 1)
    rows = np.zeros((n_tiles, P), np.int32)
    its = np.zeros((n_tiles, P), np.int32)
    valid = np.zeros((n_tiles, P), bool)
    for t, c in enumerate(cells):
        for p, (r, it) in enumerate(c):
            rows[t, p], its[t, p], valid[t, p] = r, it, True
    return rows, its, valid


# (B, I, D, k, tile, max_hist, heavy_rows): I not a multiple of the tile;
# k > tile; rows with fewer than k unmasked items; one tile
@pytest.mark.parametrize("B,I,D,k,tile,max_hist,heavy_rows", [
    (13, 1000, 8, 10, 128, 40, 0),
    (7, 300, 4, 20, 8, 30, 0),
    (6, 61, 16, 30, 16, 20, 2),
    (9, 2050, 12, 64, 512, 700, 1),
    (4, 40, 3, 5, 64, 10, 1),
])
def test_streaming_topk_matches_jax(B, I, D, k, tile, max_hist, heavy_rows):
    U, T, hist, row_ptr, items = _case(B, I, D, max_hist, seed=B * I + k, heavy_rows=heavy_rows)
    want_s, want_i = streaming_topk_with_history(
        jnp.asarray(U), jnp.asarray(T), jnp.asarray(_jax_matrix(hist, I)), k, tile)
    rows, its, valid = _jax_pairs(hist, I, tile)
    pair_s, pair_i = _stream_topk_hist_pairs(
        jnp.asarray(U), jnp.asarray(T), jnp.asarray(rows), jnp.asarray(its),
        jnp.asarray(valid), k, tile, 0, I)
    np.testing.assert_array_equal(np.asarray(pair_i), np.asarray(want_i))

    args = (torch.from_numpy(U), torch.from_numpy(T), torch.from_numpy(row_ptr),
            torch.from_numpy(items), k)
    got_s, got_i = streaming_topk_plain(*args, tile=tile)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the wrapper (the plain version at its default tile on CPU tensors)
    # gives the same ids: the result does not depend on the tiling
    reset_launch_counts()
    w_s, w_i = streaming_topk(*args)
    np.testing.assert_array_equal(w_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(want_s))
    assert launch_counts()["streaming_topk"] == 0  # no kernel on the CPU


#: B13's plain version against JAX on the same bf16 factors: both multiply
#: exactly (a bf16 x bf16 product is exact in float32) and sum the D products
#: in float32 in their own orders, so a score is within about 1e-5 |s| + 1e-6
#: of JAX's, and ids agree wherever neighbouring scores differ by more
B13_TOL = (1e-6, 1e-5)


@pytest.mark.parametrize("B,I,D,k,tile,max_hist", [
    (13, 1000, 64, 10, 128, 40),
    (7, 300, 16, 20, 64, 30),
    (9, 2050, 8, 64, 512, 700),
])
def test_streaming_topk_bf16_matches_jax(B, I, D, k, tile, max_hist):
    """B13: JAX's ``_stream_topk_hist_pairs`` on bf16 factors against the
    port's wrapper (the plain version on the CPU) on the same bf16 values,
    normal (real-valued) factors."""
    rng = np.random.default_rng(B + I + D)
    U = jnp.asarray(rng.standard_normal((B, D), np.float32)).astype(jnp.bfloat16)
    T = jnp.asarray(rng.standard_normal((I, D), np.float32)).astype(jnp.bfloat16)
    _, _, hist, row_ptr, items = _case(B, I, D, max_hist, seed=B * I + k)
    rows, its, valid = _jax_pairs(hist, I, tile)
    want_s, want_i = (np.asarray(a) for a in _stream_topk_hist_pairs(
        U, T, jnp.asarray(rows), jnp.asarray(its), jnp.asarray(valid), k, tile, 0, I))
    to_torch = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    reset_launch_counts()
    got_s, got_i = streaming_topk(to_torch(U), to_torch(T), torch.from_numpy(row_ptr),
                                  torch.from_numpy(items), k)
    assert got_s.dtype == torch.float32 and launch_counts()["streaming_topk_bf16"] == 0
    got_s, got_i = got_s.numpy(), got_i.numpy()
    atol, rtol = B13_TOL
    tol = atol + rtol * np.abs(want_s)
    np.testing.assert_array_less(np.abs(got_s - want_s), tol + 1e-30)
    gap = np.abs(np.diff(want_s, axis=1)) > tol[:, 1:]
    edge = np.ones_like(gap[:, :1])
    clear = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    assert clear.mean() > 0.9


def test_streaming_topk_dispatches_by_dtype():
    """bf16 factors go to B13, float32 to B5, mixed types are refused (no
    silent conversion)."""
    U, T, _, row_ptr, items = _case(3, 20, 8, 5, seed=1)
    args = [torch.from_numpy(a) for a in (U, T, row_ptr, items)]
    bf = [args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)]
    s16, i16 = streaming_topk(*bf, *args[2:], 5)
    s32, i32 = streaming_topk(*args, 5)  # integer factors: exact in bf16 too
    assert torch.equal(i16, i32) and torch.equal(s16, s32)
    with pytest.raises(TypeError):
        streaming_topk(bf[0], args[1], *args[2:], 5)
    with pytest.raises(TypeError):
        streaming_topk_bf16(*args, 5)


def test_streaming_topk_rejects_bad_arguments():
    U, T, _, row_ptr, items = _case(3, 20, 4, 5, seed=0)
    args = [torch.from_numpy(a) for a in (U, T, row_ptr, items)]
    with pytest.raises(ValueError, match="k"):
        streaming_topk(*args, 21)  # k > I
    with pytest.raises(ValueError, match="k"):
        streaming_topk(*args, 0)
    with pytest.raises(TypeError):
        streaming_topk(args[0].double(), *args[1:], 5)
    with pytest.raises(ValueError, match="row_ptr"):
        streaming_topk(args[0], args[1], args[2][:-1], args[3], 5)


# ------------------------------------------------------------------ B14

def _sorted_lists(m, B, k, seed, span=1000):
    """[m, B, k] candidate lists as B14's local stage writes them: integer
    scores in {-3..3} (ties everywhere), list l's ids drawn from [l span,
    (l + 1) span), each row sorted by (score desc, id asc) and holding a
    random number of real entries (0 to k), padded with (-inf, INT32_MAX)."""
    rng = np.random.default_rng(seed)
    ss = np.full((m, B, k), -np.inf, np.float32)
    ii = np.full((m, B, k), INT32_MAX, np.int32)
    for l in range(m):
        for b in range(B):
            n = int(rng.integers(0, k + 1)) if b % 3 else k
            ids = rng.choice(span, n, replace=False) + l * span
            sc = rng.integers(-3, 4, n).astype(np.float32)
            order = np.lexsort((ids, -sc))
            ss[l, b, :n], ii[l, b, :n] = sc[order], ids[order]
    return ss, ii


def _rank_places(ss):
    """The merge kernel's placement: candidate r of list l goes to r plus the
    entries of earlier lists scoring at least as high and of later lists
    scoring higher. [m, B, k] places."""
    m, B, k = ss.shape
    places = np.broadcast_to(np.arange(k), (m, B, k)).copy()
    for l in range(m):
        for l2 in range(m):
            if l2 != l:
                other = ss[l2][:, None, :]
                mine = ss[l][:, :, None]
                places[l] += ((other >= mine) if l2 < l else (other > mine)).sum(-1)
    return places


@pytest.mark.parametrize("m,k", [(1, 1), (1, 17), (2, 1), (2, 50), (3, 17), (4, 64),
                                 (4, 10)])
def test_rank_placement_is_the_stable_merge(m, k):
    """The rank formula of B14's merge kernel, in numpy, on sorted lists full
    of ties and padding: the places of a row are a permutation of [0, m k),
    and the k placed first equal JAX's ``lax.top_k`` of the lists
    concatenated in shard order (``make_sharded_streaming_topk``) and
    ``sharded_topk_merge_plain``, bit for bit."""
    B = 40
    ss, ii = _sorted_lists(m, B, k, seed=m * 100 + k)
    places = _rank_places(ss)
    flat = places.transpose(1, 0, 2).reshape(B, m * k)
    assert (np.sort(flat, 1) == np.arange(m * k)).all()
    got_s = np.full((B, k), np.nan, np.float32)
    got_i = np.zeros((B, k), np.int32)
    rows, lists, ranks = np.nonzero(places.transpose(1, 0, 2) < k)
    at = places.transpose(1, 0, 2)[rows, lists, ranks]
    got_s[rows, at] = ss[lists, rows, ranks]
    got_i[rows, at] = ii[lists, rows, ranks]
    cat_s = jnp.asarray(ss.transpose(1, 0, 2).reshape(B, m * k))
    cat_i = jnp.asarray(ii.transpose(1, 0, 2).reshape(B, m * k))
    want_s, pos = jax.lax.top_k(cat_s, k)
    want_i = np.asarray(jnp.take_along_axis(cat_i, pos, axis=1))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_i, want_i)
    for merge in (sharded_topk_merge_plain, sharded_topk_merge):  # the wrapper: plain on CPU
        p_s, p_i = merge(torch.from_numpy(ss), torch.from_numpy(ii), k)
        np.testing.assert_array_equal(p_s.numpy(), got_s)
        np.testing.assert_array_equal(p_i.numpy(), got_i)


@pytest.mark.parametrize("m,k", [(1, 10), (3, 17), (4, 64)])
def test_sharded_local_lists_are_sorted(m, k):
    """What B14's merge kernel requires of its input: each shard's local list
    (the plain version) sorted by (score desc, id asc), real entries inside
    the shard's columns, padding (-inf, INT32_MAX) only at the end, and every
    id of a shard below those of the next."""
    I = 200
    U, T, _, row_ptr, items = _case(24, I, 8, 30, seed=m + k)
    L = -(-I // m)
    lists = [sharded_topk_local_plain(*(torch.from_numpy(a) for a in (U, T[j * L:(j + 1) * L],
                                                                       row_ptr, items)),
                                      k, j * L, I) for j in range(m)]
    for j, (s, i) in enumerate(lists):
        s, i = s.numpy(), i.numpy().astype(np.int64)
        pad = i == INT32_MAX
        assert (s[pad] == -np.inf).all() and not np.isinf(s[~pad]).any()
        assert (np.diff(pad.astype(int), axis=1) >= 0).all()  # padding last
        assert ((i[~pad] >= j * L) & (i[~pad] < min((j + 1) * L, I))).all()
        ahead = (s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))
        assert (ahead | (pad[:, :-1] & pad[:, 1:])).all()


# ------------------------------------------------------------ evaluator

METRICS = ["Recall", "MRR", "NDCG", "Hit", "Precision", "ItemCoverage", "GiniIndex"]


def _setup():
    cfg = {"state": "ERROR", "device": "cpu", "metrics": METRICS, "topk": [5, 10]}
    jconfig = JaxConfig(model="CMF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    _, _, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxCMF(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(3)))
    params = {k: (np.round(np.asarray(v) * 64) / 64).astype(np.float32)
              for k, v in params.items()}

    tconfig = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    _, _, ttest = data_preparation(tconfig, tdataset)
    model = CMF(tconfig, tdataset)
    model.load_state_dict(params_from_jax(params))
    return jconfig, jmodel, params, jtest, tconfig, model, ttest


@pytest.mark.parametrize("block", [None, 16])
def test_streaming_eval_matches_dense_and_jax(block, monkeypatch):
    """``block=16`` splits the users into many streaming tiles, the last one
    ragged; results must not change."""
    jconfig, jmodel, params, jtest, tconfig, model, ttest = _setup()
    jev = JaxEvaluator(jconfig)
    want = jev.evaluate_streaming(jax.jit(jmodel.full_sort_factors("BOTH")), params, jtest)

    if block is not None:
        monkeypatch.setattr(FullSortEvaluator, "STREAM_USER_BLOCK", block)
        ttest.user_batch = block
    ev = FullSortEvaluator(tconfig)
    factors = model.full_sort_factors("BOTH")
    reset_launch_counts()
    got_ids = ev.streaming_topk_ids(factors, ttest, "cpu")
    dense_ids = ev.topk_ids(lambda users: model.full_sort(users), ttest, "cpu")
    np.testing.assert_array_equal(got_ids, dense_ids)
    got = ev.evaluate_streaming(factors, ttest, "cpu")
    assert got == want
    assert got == ev.evaluate(lambda users: model.full_sort(users), ttest, "cpu")
    assert got["recall@10"] > 0
    assert sum(launch_counts().values()) == 0

    # the mesh form (B14's plain version) over a one-rank mesh: the same
    # metrics; factors under a mesh carry their rows' first global item
    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(),
                                         world_size=1, rank=0)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        assert ev.evaluate_streaming(lambda users: (*factors(users), 0), ttest, "cpu",
                                     mesh=mesh) == got
    finally:
        torch.distributed.destroy_process_group()
    ev.need_gauc = True
    with pytest.raises(ValueError, match="GAUC"):
        ev.evaluate_streaming(factors, ttest, "cpu")


def test_streaming_eval_bf16_matches_jax():
    """``eval_score_dtype: bfloat16``: the port's streaming evaluator casts
    the factors to bf16 and scores through B13's plain version; JAX's
    ``evaluate_streaming`` casts them the same way. The parameters are
    multiples of 1/64 of at most 8 significant bits, exact in bf16, so both
    scores are exact and the metrics equal; the dense path ignores the knob,
    as in JAX."""
    jconfig, jmodel, params, jtest, tconfig, model, ttest = _setup()
    jconfig["eval_score_dtype"] = tconfig["eval_score_dtype"] = "bfloat16"
    jev = JaxEvaluator(jconfig)
    want = jev.evaluate_streaming(jax.jit(jmodel.full_sort_factors("BOTH")), params, jtest)
    ev = FullSortEvaluator(tconfig)
    assert ev.score_dtype == torch.bfloat16
    got = ev.evaluate_streaming(model.full_sort_factors("BOTH"), ttest, "cpu")
    assert got == want
    assert got == ev.evaluate(lambda users: model.full_sort(users), ttest, "cpu")
    tconfig["eval_score_dtype"] = "int8"
    with pytest.raises(ValueError, match="eval_score_dtype"):
        FullSortEvaluator(tconfig)


def test_trainer_routes_by_streaming_threshold(monkeypatch):
    """A lowered ``streaming_topk_threshold`` sends every validation and the
    test pass through the streaming evaluator, with the dense path's
    results (the pattern of tests/test_streaming_eval.py)."""
    calls = {"streaming": 0, "dense": 0}
    stream0, dense0 = FullSortEvaluator.streaming_topk_ids, FullSortEvaluator.topk_ids

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(FullSortEvaluator, "streaming_topk_ids", counting("streaming", stream0))
    monkeypatch.setattr(FullSortEvaluator, "topk_ids", counting("dense", dense0))
    base = {"state": "ERROR", "show_progress": False, "device": "cpu",
            "train_batch_size": 1024, "train_epochs": ["BOTH:2"]}
    dense = run_recbole_cdr(model="CMF", config_dict={**base, "streaming_topk_threshold": 10 ** 9})
    assert calls == {"streaming": 0, "dense": 3}
    streaming = run_recbole_cdr(model="CMF", config_dict={**base, "streaming_topk_threshold": 1})
    assert calls == {"streaming": 3, "dense": 3}
    assert streaming["test_result"] == dense["test_result"]
    assert streaming["best_valid_result"] == dense["best_valid_result"]
