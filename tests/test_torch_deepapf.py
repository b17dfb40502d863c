"""DeepAPF in the PyTorch port against the JAX model, on the CPU (where
kernel B16's wrappers run their plain versions), in both overlap modes: the
bundled ml-1m -> ml-100k pair overlaps on items, the small synthetic pair
of ``tests/test_user_overlap.py`` on users. The same weights
(``params_from_jax``: ``user_mlp.0.w``, ``user_mlp.1.w``, ...) and, for the
epoch, the same random bits go to both. Tolerances, each with its case:

- B16's plain forward and backward, from the five tables and both
  domains' ids, against JAX's ``_forward`` of each domain and its
  ``jax.vjp``, and the loss and every parameter's gradient on a batch:
  ``LOSS_TOL`` / ``GRAD_TOL`` (``tests/test_oracle_equivalence.py:31-32``);
- two runs of B16's plain backward with four torch threads: bit-equal (its
  ``F.embedding`` gathers add a row's terms in position order);
- ``predict`` and the predict fallback's full-sort probabilities
  (``predict_grid``, one B16 grid call a tile) against JAX's ``predict_fn``
  and ``make_predict_full_sort``: rtol 2e-4, atol 2e-5
  (``tests/test_oracle_equivalence.py::_check_full_sort``);
- one BOTH epoch with JAX's shuffle and negative bits: rtol 5e-3 / atol
  1e-5, the CMF epoch test's tolerance;
- the mask's boundary (an entity id equal to the overlapped count keeps its
  share logit, one above it is masked) and the masked share row's gradient:
  exactly 0, as JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.models.deepapf import DeepAPF as JaxDeepAPF
from recbole_cdr_tpu.trainer.trainer import make_predict_full_sort as jax_predict_full_sort

from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.models.base import CrossDomainRecommender
from recbole_cdr_tpu_torch.models.deepapf import DeepAPF
from recbole_cdr_tpu_torch.ops.deepapf_attention import (
    Pairs,
    Tables,
    Weights,
    deepapf_attention,
    deepapf_backward,
    deepapf_grid,
    deepapf_grid_plain,
)
from recbole_cdr_tpu_torch.trainer.trainer import (
    build_optimizer,
    make_predict_full_sort,
    make_train_step,
)
from recbole_cdr_tpu_torch.utils import get_model
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from test_torch_clfm import (
    SCORE_TOL,
    check_predict,
    one_epoch_match,
    user_overlap_cfg,
)
from test_torch_dcdcsr import assert_loss_and_grads_match, build_pair, jax_leaf, phase_batch
from test_torch_model import GRAD_TOL, LOSS_TOL, _tbatch
from test_user_overlap import pair_root  # noqa: F401  (fixture)

MODES = ("overlap_items", "overlap_users")


@pytest.fixture(scope="module")
def items_pair():
    return build_pair("DeepAPF", JaxDeepAPF, DeepAPF)


@pytest.fixture(scope="module")
def users_pair(pair_root):  # noqa: F811
    return build_pair("DeepAPF", JaxDeepAPF, DeepAPF, user_overlap_cfg(pair_root))


@pytest.fixture(params=MODES)
def pair(request):
    m = request.getfixturevalue("items_pair" if request.param == "overlap_items"
                                else "users_pair")
    assert m["jmodel"].mode == m["tmodel"].mode == request.param
    return m


def _dead(mode):
    side = "item" if mode == "overlap_users" else "user"
    return {f"share_{side}_embedding", f"{side}_mlp"}


def test_get_model_resolves_deepapf():
    assert get_model("DeepAPF") is DeepAPF


def test_params_from_jax_names(pair):
    """Every leaf of JAX's pytree lands on the port's parameter of the same
    dotted name (the MLPs' second layer: ``w`` alone)."""
    named = dict(pair["tmodel"].named_parameters())
    converted = params_from_jax(pair["params"])
    assert sorted(converted) == sorted(named)
    assert {"user_mlp.0.w", "user_mlp.0.b", "user_mlp.1.w", "item_mlp.1.w",
            "predict_layer"} <= set(named)
    assert "user_mlp.1.b" not in named


def _b16_call(pair, n=48):
    """Random weights (numpy seed 0) and both domains' pairs, ``n`` each:
    the entity ids of each domain include 0, the overlapped count, the one
    above it (the strict ``>``) and the largest id, and the target pairs
    repeat the source pairs' first entities, so a share row collects pairs
    of both domains. Returns (params, (users, items) per domain, the port's
    parameters as leaves, its B16 operands)."""
    tmodel = pair["tmodel"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32), pair["params"])
    side = "user" if tmodel.mode == "overlap_users" else "item"
    n_ov, total = ((tmodel.overlapped_num_users, tmodel.total_num_users) if side == "user"
                   else (tmodel.overlapped_num_items, tmodel.total_num_items))
    doms = {}
    for d in ("source", "target"):
        users = rng.integers(0, tmodel.total_num_users, n).astype(np.int32)
        items = rng.integers(0, tmodel.total_num_items, n).astype(np.int32)
        ent = users if side == "user" else items
        ent[:4] = [0, n_ov, n_ov + 1, total - 1]
        ent[4:8] = ent[8:12]  # repeats inside a domain
        if d == "target":
            ent[12:20] = doms["source"][0 if side == "user" else 1][12:20]
        doms[d] = (users, items)
    t = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in params_from_jax(params).items()}
    other_side = "item" if side == "user" else "user"
    tabs = Tables(t[f"share_{side}_embedding"], t[f"source_{side}_embedding"],
                  t[f"target_{side}_embedding"], t[f"source_{other_side}_embedding"],
                  t[f"target_{other_side}_embedding"])
    ids = [torch.from_numpy(a) for d in ("source", "target")
           for a in (doms[d] if side == "user" else doms[d][::-1])]
    w = Weights(t[f"{side}_mlp.0.w"], t[f"{side}_mlp.0.b"], t[f"{side}_mlp.1.w"],
                t["predict_layer"])
    return params, doms, t, (tabs, Pairs(*ids), n_ov, w)


def test_b16_plain_matches_forward_and_vjp(pair):
    """B16's plain forward and backward, through ``deepapf_attention`` on
    CPU tensors (the five tables and both domains' ids), against
    ``_forward`` of each domain and its ``jax.vjp`` with respect to every
    table and weight, for a random cotangent; the masked entities' share
    rows get exactly zero gradient, the overlapped count's does not."""
    jmodel, tmodel = pair["jmodel"], pair["tmodel"]
    params, doms, t, (tabs, pairs, n_ov, w) = _b16_call(pair)
    n = doms["source"][0].shape[0]
    g = np.random.default_rng(1).normal(size=2 * n).astype(np.float32)

    def both(p):
        return jnp.concatenate([jmodel._forward(p, jnp.asarray(u), jnp.asarray(i), d)
                                for d, (u, i) in doms.items()])

    want, vjp = jax.vjp(jax.jit(both), params)
    (want_g,) = vjp(jnp.asarray(g))
    ent = torch.cat([pairs.ent_src, pairs.ent_tgt]).long()
    mask = ent > n_ov
    assert mask[:3].tolist() == [False, False, True]
    ops.reset_launch_counts()
    got = deepapf_attention(tabs, pairs, n_ov, w)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS_TOL)
    got.backward(torch.from_numpy(g))
    side = "user" if tmodel.mode == "overlap_users" else "item"
    other_side = "item" if side == "user" else "user"
    names = [f"{p}_{side}_embedding" for p in ("share", "source", "target")]
    names += [f"{p}_{other_side}_embedding" for p in ("source", "target")]
    names += [f"{side}_mlp.0.w", f"{side}_mlp.0.b", f"{side}_mlp.1.w", "predict_layer"]
    for name in names:
        np.testing.assert_allclose(t[name].grad.numpy(), jax_leaf(want_g, name), err_msg=name,
                                   **GRAD_TOL)
    share_g = t[f"share_{side}_embedding"].grad
    assert torch.all(share_g[torch.unique(ent[mask])] == 0)
    assert share_g[n_ov].abs().sum() > 0
    assert not any(ops.launch_counts().values())  # plain on the CPU


def test_b16_plain_backward_repeats_across_threads(pair):
    """Two runs of B16's plain backward on the CPU with four torch threads
    give bit-equal gradients of every table and weight."""
    _, _, _, (tabs, pairs, n_ov, w) = _b16_call(pair, n=2048)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=4096).astype(np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [deepapf_backward(tabs, pairs, n_ov, w, g) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_deepapf_loss_and_grads_match_jax(pair):
    """Both domains' pairs through one B16 call; every parameter, the dead
    side's with JAX's zero gradient and none in the port."""
    batch = phase_batch(pair["jtrain"], "BOTH")
    tmodel = pair["tmodel"]
    assert_loss_and_grads_match(pair["jmodel"], pair["params"], tmodel, "BOTH", batch)
    dead = _dead(tmodel.mode)
    for name, p in tmodel.named_parameters():
        assert (p.grad is None) == (name.split(".", 1)[0] in dead), name


def test_dead_side_never_moves(pair):
    """A training step leaves the other side's share table and attention MLP
    untouched, and the optimizer never creates state for them."""
    import copy

    model = copy.deepcopy(pair["tmodel"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(pair["tconfig"], model.parameters())
    step = make_train_step(model, opt, model.loss_fn("BOTH"), model.trainable_predicate("BOTH"))
    step(_tbatch(phase_batch(pair["jtrain"], "BOTH")))
    dead = _dead(model.mode)
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved != (name.split(".", 1)[0] in dead), name
        assert (p in opt.state) != (name.split(".", 1)[0] in dead), name


def test_predict_matches_jax(pair):
    check_predict(pair)


def test_predict_fallback_matches_jax(pair):
    """The full-sort probabilities of the predict fallback against JAX's
    ``make_predict_full_sort``: one B16 grid call a tile; the default
    chunked hook (pairs through ``predict``) agrees on the item axis
    reversed."""
    jmodel, tmodel, params = pair["jmodel"], pair["tmodel"], pair["params"]
    item_num = pair["ttest"].item_num
    users = np.arange(1, 41)
    want = np.asarray(jax_predict_full_sort(jmodel, "TARGET", item_num)(params,
                                                                        jnp.asarray(users)))
    assert tmodel.full_sort_fn("TARGET") is None
    fs = make_predict_full_sort(tmodel, item_num)
    with torch.no_grad():
        got = fs(torch.from_numpy(users)).numpy()
        items = torch.arange(item_num).flip(0)
        grid = tmodel.predict_grid(torch.from_numpy(users), items)
        pairs = CrossDomainRecommender.predict_grid(tmodel, torch.from_numpy(users), items)
    assert got.shape == want.shape == (len(users), item_num)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    torch.testing.assert_close(grid, pairs, rtol=0, atol=1e-6)
    torch.testing.assert_close(grid, torch.from_numpy(got).flip(1), rtol=0, atol=0)


def test_grid_plain_chunks(monkeypatch):
    """The plain grid over more pairs than one chunk agrees with it in one
    chunk (the chunking only bounds memory) within 1e-6: torch's CPU matmul
    rounds a row by the shape of the batch it sits in."""
    import recbole_cdr_tpu_torch.ops.deepapf_attention as b16

    g = torch.Generator().manual_seed(0)
    D = 8
    tabs = [torch.randn(30, D, generator=g) for _ in range(3)]
    w = Weights(torch.randn(D, D, generator=g), torch.randn(D, generator=g),
                torch.randn(D, 1, generator=g), torch.randn(D, 1, generator=g))
    users, items = torch.arange(0, 30, 3), torch.arange(29, -1, -1)
    whole = deepapf_grid(*tabs, users, items, 12, True, w)
    monkeypatch.setattr(b16, "PAIR_BUDGET", 7)
    chunked = deepapf_grid_plain(*tabs, users, items, 12, True, w)
    assert whole.shape == (10, 30)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_one_epoch_deepapf_parameter_match(mode, request):
    extra = {} if mode == "overlap_items" else {
        **user_overlap_cfg(request.getfixturevalue("pair_root")), "train_batch_size": 256}
    model, params0 = one_epoch_match("DeepAPF", JaxDeepAPF, DeepAPF, extra)
    assert model.mode == mode
    for name, p in model.named_parameters():
        if name.split(".", 1)[0] in _dead(mode):
            np.testing.assert_array_equal(p.detach().numpy(), jax_leaf(params0, name))


@pytest.mark.parametrize("mode", MODES)
def test_run_recbole_cdr_deepapf_on_cpu(mode, request):
    """BOTH:1 with validation through the predict fallback, finite metrics;
    no kernel launches on the CPU."""
    extra = {} if mode == "overlap_items" else user_overlap_cfg(request.getfixturevalue("pair_root"))
    ops.reset_launch_counts()
    result = run_recbole_cdr(model="DeepAPF", config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 1024,
        "train_epochs": ["BOTH:1"], "eval_step": 1, **extra})
    assert result["model"].mode == mode
    assert all(math.isfinite(v) for v in result["test_result"].values())
    assert all(math.isfinite(h["loss"]) for h in result["history"])
    assert not any(ops.launch_counts().values())
