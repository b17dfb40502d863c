"""BiTGCF in the PyTorch port against the JAX model, on the bundled ml-1m ->
ml-100k pair, on the CPU (where kernel B8's wrapper runs its plain version).

The same weights (``params_from_jax``) and, for dropout, the same random
bits go to both: JAX's ``bernoulli`` is ``uniform < keep`` on
``jax.random.bits`` under the same key, and B8 builds its mask from those
bits (``ops/graph_layer.py::keep_mask``). Tolerances, each with its case:

- the normalised adjacency: exactly equal (the same scipy arithmetic);
- B8 alone: forward within rtol 1e-5 / atol 1e-6 and backward within rtol
  1e-5 / atol 1e-5 of ``_graph_layer`` and its ``jax.vjp`` (the sparse sums
  run in another order);
- loss and gradients: ``LOSS_TOL`` / ``GRAD_TOL`` of
  ``tests/test_oracle_equivalence.py:31-32``;
- full-sort scores: rtol 2e-4 / atol 2e-5 (two propagations and a 192-wide
  dot product in another order);
- streaming evaluation: equal metrics, and ids equal wherever neighbouring
  scores differ by more than 1e-5;
- one BOTH epoch with JAX's shuffle, negative and dropout bits: rtol 5e-3 /
  atol 1e-5, the CMF epoch test's tolerance.

Also on the host: B8's plain backward on a non-symmetric matrix against
autograd through the dense matrix, and the kernel's work split
(``make_csr``) replayed piece by piece.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.evaluator.evaluator import FullSortEvaluator as JaxEvaluator
from recbole_cdr_tpu.models.bitgcf import BiTGCF as JaxBiTGCF
from recbole_cdr_tpu.ops.topk import streaming_topk_with_history
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.models.bitgcf import BiTGCF
from recbole_cdr_tpu_torch.ops import launch_counts, reset_launch_counts
from recbole_cdr_tpu_torch.ops.graph_layer import (
    PIECE,
    PIECES_PER_BLOCK,
    SINGLE,
    csr_from_scipy,
    graph_layer,
    graph_layer_backward,
    graph_layer_forward,
    keep_mask,
    make_csr,
)
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from test_torch_epoch import JaxRandomSource, _u32_as_i32, jax_dropout_draw
from test_torch_model import GRAD_TOL, LOSS_TOL, _tbatch

TABLES = ("source_user_embedding", "target_user_embedding", "source_item_embedding",
          "target_item_embedding")


def _models(extra=None):
    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", **(extra or {})}
    jconfig = JaxConfig(model="BiTGCF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxBiTGCF(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    tconfig = CDRConfig(model="BiTGCF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    _, _, ttest = data_preparation(tconfig, tdataset)
    tmodel = BiTGCF(tconfig, tdataset)
    tmodel.load_state_dict(params_from_jax(params))
    return jconfig, jmodel, params, jtrain, jtest, tconfig, tmodel, ttest


@pytest.fixture(scope="module")
def models():
    return _models()


def _coo(csr):
    n = csr.row_ptr.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(csr.row_ptr.numpy()))
    return rows, csr.col.numpy(), csr.val.numpy()


def test_norm_adj_equals_jax(models):
    """Both domains' CSR (and the transpose's) hold exactly the values of
    JAX's BCOO adjacency; the degree buffers are JAX's."""
    _, jmodel, _, _, _, _, tmodel, _ = models
    for domain in ("source", "target"):
        adj = getattr(jmodel, f"{domain}_adj")
        jrow, jcol = np.asarray(adj.indices).T
        order = np.lexsort((jcol, jrow))
        jval = np.asarray(adj.data)
        csr, csr_t = tmodel._adj(domain)
        rows, cols, vals = _coo(csr)
        np.testing.assert_array_equal(rows, jrow[order])
        np.testing.assert_array_equal(cols, jcol[order])
        np.testing.assert_array_equal(vals, jval[order])
        order_t = np.lexsort((jrow, jcol))
        rows_t, cols_t, vals_t = _coo(csr_t)
        np.testing.assert_array_equal(rows_t, jcol[order_t])
        np.testing.assert_array_equal(cols_t, jrow[order_t])
        np.testing.assert_array_equal(vals_t, jval[order_t])
        for kind in ("user", "item"):
            name = f"{domain}_{kind}_deg"
            np.testing.assert_array_equal(getattr(tmodel, name).numpy(),
                                          np.asarray(getattr(jmodel, name)))


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_graph_layer_plain_matches_jax(models, drop):
    """B8's forward against ``_graph_layer`` and its backward against
    ``jax.vjp`` of it, with JAX's dropout bits injected at 0.3; the mask
    itself equals JAX's ``bernoulli``."""
    _, jmodel, _, _, _, _, tmodel, _ = models
    jmodel.drop_rate = tmodel.drop_rate = drop
    keep = 1.0 - drop
    rng = np.random.default_rng(3)
    n = tmodel.total_num_users + tmodel.total_num_items
    x = (0.1 * rng.normal(size=(n, 64))).astype(np.float32)
    g = rng.normal(size=(n, 64)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, vjp = jax.vjp(lambda a: jmodel._graph_layer(jmodel.source_adj, a, key, True),
                        jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(g))

    bits = _u32_as_i32(jax.random.bits(key, x.shape, jnp.uint32)) if drop else None
    if drop:
        np.testing.assert_array_equal(keep_mask(bits, keep).numpy(),
                                      np.asarray(jax.random.bernoulli(key, keep, x.shape)))
    csr, csr_t = tmodel._adj("source")
    xt = torch.from_numpy(x).requires_grad_()
    reset_launch_counts()
    new, side = graph_layer_forward(csr, xt.detach(), bits, keep)
    got = graph_layer(xt, csr, csr_t, bits, keep)
    torch.testing.assert_close(got.detach(), new, rtol=0, atol=0)
    np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got.backward(torch.from_numpy(g))
    gx = graph_layer_backward(csr_t, xt.detach(), side, bits, keep, torch.from_numpy(g))
    torch.testing.assert_close(xt.grad, gx, rtol=0, atol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    assert launch_counts()["graph_layer_forward"] == launch_counts()["graph_layer_backward"] == 0


def test_graph_layer_backward_uses_the_transpose():
    """A non-symmetric L: the backward's product runs on the CSR it is given
    (the transpose's), and matches autograd through a dense matrix."""
    rng = np.random.default_rng(5)
    L = sp.random(40, 40, density=0.1, random_state=7, dtype=np.float32)
    L = L.tolil()
    L[3, :] = 0  # an empty row
    L = L.tocsr()
    x = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)).requires_grad_()
    bits = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (40, 8)).astype(np.int32))
    out = graph_layer(x, csr_from_scipy(L), csr_from_scipy(L.T), bits, 0.7)
    dense = torch.from_numpy(L.toarray())
    x2 = x.detach().clone().requires_grad_()
    side = dense @ x2
    want = torch.where(keep_mask(bits, 0.7), (x2 + side + x2 * side) / 0.7, 0.0)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    out.backward(g)
    want.backward(g)
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_bitgcf_loss_and_grads_match_jax(models, drop):
    _, jmodel, params, jtrain, _, _, tmodel, _ = models
    jmodel.drop_rate = tmodel.drop_rate = drop
    batch = next(iter(jtrain))
    r_loss = jax.random.PRNGKey(5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn("BOTH")(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                         r_loss if drop else None)
    )(params)
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss(_tbatch(batch), jax_dropout_draw(r_loss) if drop else None)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LOSS_TOL)
    for name in TABLES:
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(),
                                   np.asarray(jgrads[name]), err_msg=name, **GRAD_TOL)


def test_bitgcf_full_sort_matches_jax(models):
    _, jmodel, params, _, _, _, tmodel, _ = models
    users = np.arange(1, 60)
    want = np.asarray(jmodel.full_sort_fn("BOTH")(params, jnp.asarray(users)))
    with torch.no_grad():
        got = tmodel.full_sort(torch.from_numpy(users)).numpy()
    assert got.shape == (len(users), tmodel.target_num_items)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_bitgcf_streaming_eval_matches_jax(models):
    """The propagated factors through the streaming evaluator: the metrics
    of JAX's ``evaluate_streaming``, and JAX's streaming top-k ids wherever
    neighbouring scores do not tie within 1e-5."""
    jconfig, jmodel, params, _, jtest, tconfig, tmodel, ttest = models
    want = JaxEvaluator(jconfig).evaluate_streaming(
        jmodel.full_sort_factors("BOTH"), params, jtest)
    ev = FullSortEvaluator(tconfig)
    factors = tmodel.full_sort_factors("BOTH")
    got = ev.evaluate_streaming(factors, ttest, "cpu")
    assert got == want

    uids = np.asarray(ttest.uid_list, np.int64)
    I, k = ttest.item_num, ev.max_k
    hp = ttest.hist_ptr
    hist = np.full((len(uids), max(int(np.diff(hp).max()), 1)), I, np.int32)
    for r in range(len(uids)):
        hist[r, :hp[r + 1] - hp[r]] = ttest.hist_items[hp[r]:hp[r + 1]]
    ju, jt = jmodel.full_sort_factors("BOTH")(params, jnp.asarray(uids))
    want_s, want_i = streaming_topk_with_history(ju, jt, jnp.asarray(hist), k, 64)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_i = ev.streaming_topk_ids(factors, ttest, "cpu")
    gap = np.abs(np.diff(want_s, axis=1)) > 1e-5
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], want_i[clear])


def test_one_epoch_bitgcf_parameter_match():
    """One BOTH epoch of the port's loop (torch Adam, plain B8 and K1-K3)
    against JAX's DeviceEpochLoop from the same weights, with JAX's shuffle,
    negative and dropout bits injected through the random source."""
    cfg = {"state": "ERROR", "train_batch_size": 1024, "device": "cpu",
           "train_epochs": ["BOTH:1"]}
    base_rng = jax.random.PRNGKey(1)

    jconfig = JaxConfig(model="BiTGCF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxBiTGCF(jconfig, jdataset)
    assert jmodel.drop_rate == 0.3
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    sopt = SingleOptimizer(jconfig)
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), sopt.for_phase(lambda k: True, list(params0)),
        jtrain, jconfig["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng, donate=False,
    )
    jparams, _, jloss = jl.run_epoch(params0, sopt.init(params0), 0)

    tconfig = CDRConfig(model="BiTGCF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = BiTGCF(tconfig, tdataset)
    model.load_state_dict(params_from_jax(jax.device_get(params0)))
    step = make_train_step(model, build_optimizer(tconfig, model.parameters()),
                           model.loss_fn("BOTH"), lambda n: True)
    tl = torch_loop.DeviceEpochLoop(
        TrainMode.BOTH, step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, JaxRandomSource(base_rng), "cpu",
    )
    assert tl.steps_per_epoch == jl.steps_per_epoch > 1
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-3, atol=1e-5)
    for name in TABLES:
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(jparams[name]), rtol=5e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("extra", [
    {},
    {"phase_optimizer": "sparse", "streaming_topk_threshold": 1, "connect_way": "mean"},
])
def test_run_recbole_cdr_bitgcf_on_cpu(extra, capsys):
    """The entry point end to end; with ``phase_optimizer: sparse`` BiTGCF,
    which declares no ``sparse_spec``, takes the dense fallback with the
    JAX package's warning."""
    result = run_recbole_cdr(model="BiTGCF", config_dict={
        "state": "WARNING", "show_progress": False, "device": "cpu",
        "train_batch_size": 1024, "train_epochs": ["BOTH:2"], **extra})
    values = list(result["test_result"].values()) + list(result["best_valid_result"].values())
    assert values and all(math.isfinite(v) for v in values)
    assert result["test_result"]["recall@10"] > 0
    hist = result["history"]
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
    fell_back = "declares no sparse_spec" in capsys.readouterr().out
    assert fell_back == ("phase_optimizer" in extra)


@pytest.mark.parametrize("degrees", [[0, 1, 64, 65, 5000, 3, 0], [0], [200], [7] * 40,
                                     [1] * 15 + [65, 20_001, 3]])
def test_make_csr_schedule_covers_each_nonzero_once(degrees):
    """The kernel's work split, replayed on the host: the pieces of each row
    cover its nonzeros once, in order, at most ``PIECE`` at a time; a block
    of ``PIECES_PER_BLOCK`` pieces sums each run of one row's pieces in
    piece order; a row over several blocks (a split row, of more than 20,000
    nonzeros in the last case) has one partial slot a block, consecutive and
    in block order, named by the first of its pieces in each block, and is
    finished from its slots in that order; a row's only piece is marked
    ``SINGLE``."""
    rng = np.random.default_rng(len(degrees))
    n = len(degrees)
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(degrees)]), dtype=torch.int32)
    nnz = int(row_ptr[-1])
    col = torch.from_numpy(rng.integers(0, n, nnz).astype(np.int32))
    val = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
    csr = make_csr(row_ptr, col, val)
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    out = torch.full((n, 3), float("nan"))
    partial = {}
    covered = np.zeros(nnz, np.int64)
    pieces = csr.pieces.tolist()
    for b0 in range(0, len(pieces), PIECES_PER_BLOCK):  # a block of the launch
        block = pieces[b0:b0 + PIECES_PER_BLOCK]
        for g, (row, lo, hi, slot) in enumerate(block):
            assert int(row_ptr[row]) <= lo <= hi <= int(row_ptr[row + 1]) and hi - lo <= PIECE
            covered[lo:hi] += 1
            assert (slot == SINGLE) == (degrees[row] <= PIECE)
            if g and block[g - 1][0] == row:  # not the first of its row in the block
                assert slot == -1
                continue
            run = [q for q in block[g:] if q[0] == row]
            run = run[:next((k for k in range(1, len(run)) if run[k][0] != row), len(run))]
            acc = torch.zeros(3)
            for _, a, z, _ in run:  # the run's pieces in piece order
                acc = acc + (val[a:z, None] * x[col[a:z].long()]).sum(0)
            if slot < 0:
                out[row] = acc
            else:
                assert slot not in partial
                partial[slot] = acc
    assert (covered == 1).all()
    split_rows = [r for r in range(n)
                  if np.unique(np.flatnonzero(csr.pieces[:, 0].numpy() == r)
                               // PIECES_PER_BLOCK).size > 1]
    assert csr.split_ptr.shape[0] == len(split_rows) + 1
    assert sorted(partial) == list(range(len(partial))) == list(range(int(csr.split_ptr[-1])))
    assert csr.slot_owner.shape[0] == len(partial) and not csr.split_count.any()
    for h, row in enumerate(split_rows):  # the last block of each split row
        s0, s1 = int(csr.split_ptr[h]), int(csr.split_ptr[h + 1])
        assert s1 - s0 >= 2 and (csr.slot_owner[s0:s1] == h).all()
        lead = [p for p, q in enumerate(pieces) if q[0] == row and q[3] >= 0]
        assert [pieces[p][3] for p in lead] == list(range(s0, s1))  # block order
        assert [p // PIECES_PER_BLOCK for p in lead] == sorted(
            {p // PIECES_PER_BLOCK for p, q in enumerate(pieces) if q[0] == row})
        acc = partial[s0]
        for s in range(s0 + 1, s1):
            acc = acc + partial[s]
        out[row] = acc
    torch.testing.assert_close(out, torch.from_numpy(
        np.stack([sum((float(val[k]) * x[int(col[k])].numpy()
                       for k in range(int(row_ptr[r]), int(row_ptr[r + 1]))), np.zeros(3))
                  for r in range(n)]).astype(np.float32)), rtol=1e-5, atol=1e-5)
