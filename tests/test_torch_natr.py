"""NATR in the PyTorch port against the JAX model, on the CPU (where kernel
B9's wrappers run their plain versions), in both overlap modes: the bundled
ml-1m -> ml-100k pair overlaps on items, and a small synthetic pair (built as
``tests/test_user_overlap.py`` builds it) overlaps on users.

The same weights (``params_from_jax``, nested ``transfer.w`` and the like)
and, for the epochs, the same random bits go to both. Tolerances, each with
its case:

- history matrices and their masks: exactly equal;
- B9 alone (``_phase2_logit`` and its ``jax.vjp``, short, truncated and
  empty histories): ``LOSS_TOL`` on the logits, ``GRAD_TOL`` on the
  gradients (``tests/test_oracle_equivalence.py:31-32``);
- the SOURCE and TARGET losses and every trainable parameter's gradient:
  ``LOSS_TOL`` / ``GRAD_TOL``;
- the predict fallback's full-sort probabilities: atol 2e-6 (probabilities
  of logits that the two-stage form sums in another order); top-k ids equal
  wherever neighbouring scores differ by more than 2e-6;
- the cached anchor table's grid against the one-call full-sort plain
  version: atol 1e-6 (the table's batched transfer rounds apart);
- one SOURCE and one TARGET epoch with JAX's shuffle and negative bits:
  rtol 5e-3 / atol 1e-5, the CMF epoch test's tolerance.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.models.natr import NATR as JaxNATR
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.trainer.trainer import make_predict_full_sort as jax_predict_full_sort
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode
from recbole_cdr_tpu.utils.enums import train_mode2state as jax_mode2state

import recbole_cdr_tpu_torch.models.natr as natr_module
import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.models.base import CrossDomainRecommender
from recbole_cdr_tpu_torch.models.natr import NATR
from recbole_cdr_tpu_torch.ops.natr_attention import (
    History,
    Weights,
    natr_attention,
    natr_full_sort_plain,
)
from recbole_cdr_tpu_torch.trainer.trainer import (
    build_optimizer,
    make_predict_full_sort,
    make_train_step,
)
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from test_torch_epoch import JaxRandomSource
from test_torch_model import GRAD_TOL, LOSS_TOL, _tbatch
from test_user_overlap import pair_root  # noqa: F401  (fixture)

TARGET_PARAMS = ("target_user_embedding", "target_item_embedding", "transfer.w", "transfer.b",
                 "unit_attention.w", "unit_attention.b", "domain_attention.w",
                 "domain_attention.b")
SOURCE_PARAMS = ("source_user_embedding", "source_item_embedding")


def _user_overlap_cfg(root):
    return {"source_dataset": "uo-src", "target_dataset": "uo-tgt",
            "source_data_path": root, "target_data_path": root,
            "source_user_inter_num_interval": "[2,inf)",
            "source_item_inter_num_interval": "[2,inf)",
            "target_user_inter_num_interval": "[2,inf)",
            "target_item_inter_num_interval": "[2,inf)",
            "source_val_interval": None, "target_val_interval": None,
            "eval_batch_size": 2048}


def _models(extra=None):
    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", **(extra or {})}
    jconfig = JaxConfig(model="NATR", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, jvalid, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxNATR(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    tconfig = CDRConfig(model="NATR", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, ttest = data_preparation(tconfig, tdataset)
    tmodel = NATR(tconfig, tdataset)
    tmodel.load_state_dict(params_from_jax(params))
    return dict(jconfig=jconfig, jdataset=jdataset, jmodel=jmodel, params=params,
                jtrain=jtrain, jtest=jtest, tconfig=tconfig, tdataset=tdataset,
                tmodel=tmodel, ttrain=ttrain, ttest=ttest)


@pytest.fixture(scope="module")
def items_pair():
    return _models()


@pytest.fixture(scope="module")
def users_pair(pair_root):  # noqa: F811
    return _models(_user_overlap_cfg(pair_root))


@pytest.fixture(params=["overlap_items", "overlap_users"])
def pair(request):
    m = request.getfixturevalue("items_pair" if request.param == "overlap_items"
                                else "users_pair")
    assert m["jmodel"].mode == m["tmodel"].mode == request.param
    return m


def _grads(tmodel):
    named = dict(tmodel.named_parameters())
    return {n: named[n].grad for n in named}


def _jax_grad(jgrads, name):
    node = jgrads
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


def test_history_matrices_equal_jax(pair):
    """Both matrices of both domains, and the model's truncated history and
    mask, exactly as JAX builds them."""
    jd, td = pair["jdataset"], pair["tdataset"]
    for fn in ("history_item_matrix", "history_user_matrix"):
        for domain in ("source", "target"):
            for max_len in (None, 3):
                want = getattr(jd, fn)(domain=domain, max_len=max_len)
                got = getattr(td, fn)(domain=domain, max_len=max_len)
                for w, g in zip(want, got):
                    np.testing.assert_array_equal(g, w, err_msg=f"{fn} {domain} {max_len}")
    jmodel, tmodel = pair["jmodel"], pair["tmodel"]
    np.testing.assert_array_equal(tmodel.history.numpy(), np.asarray(jmodel._history))
    np.testing.assert_array_equal(tmodel.hist_mask.numpy(), np.asarray(jmodel._hist_mask))


def _anchor_ids(model, rng, n):
    """Pair ids whose anchors include PAD (all slots masked), entities with
    no target history (all masked) and the longest histories (truncated)."""
    lens = model.hist_mask.numpy().sum(1)
    full_users = np.arange(1, model.target_num_users)
    full_items = np.arange(1, model.target_num_items)
    users = rng.choice(full_users, n)
    items = rng.choice(full_items, n)
    anchors = users if model.mode == "overlap_items" else items
    anchors[:3] = [0, int(np.argmax(lens)), int(np.argmin(lens[1:])) + 1]
    if model.mode == "overlap_items":
        anchors[3] = model.total_num_users - 1  # source-only: no target history
    else:
        anchors[3] = model.total_num_items - 1
    return users, items


@pytest.mark.parametrize("max_len", [50, 2])
def test_attention_plain_matches_phase2_logit(pair, max_len):
    """B9's plain forward and backward, through ``natr_attention`` on CPU
    tensors, against ``_phase2_logit`` and its ``jax.vjp`` with random
    weights (numpy seed 0) and a random cotangent; ``max_len`` 2 truncates
    most histories."""
    jmodel, tmodel = pair["jmodel"], pair["tmodel"]
    saved = jmodel.max_inter_length, jmodel._history, jmodel._hist_mask
    hist, _, lens = (pair["jdataset"].history_item_matrix if jmodel.mode == "overlap_items"
                     else pair["jdataset"].history_user_matrix)(domain="target")
    hist = hist[:, :max_len]
    jmodel._history = jnp.asarray(hist)
    jmodel._hist_mask = jnp.asarray(np.arange(hist.shape[1])[None, :]
                                    < np.minimum(lens, hist.shape[1])[:, None])
    try:
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32), pair["params"])
        users, items = _anchor_ids(tmodel, rng, 64)
        g = rng.normal(size=64).astype(np.float32)
        want, vjp = jax.vjp(jax.jit(lambda p: jmodel._phase2_logit(p, jnp.asarray(users),
                                                                   jnp.asarray(items))), params)
        (want_g,) = vjp(jnp.asarray(g))

        t = {k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in params_from_jax(params).items()}
        src = t["source_item_embedding" if tmodel.mode == "overlap_items"
                else "source_user_embedding"].detach()
        history = History(src, torch.from_numpy(hist.astype(np.int32)),
                          torch.from_numpy(np.asarray(jmodel._hist_mask)))
        pu = t["target_user_embedding"][torch.from_numpy(users)]
        qi = t["target_item_embedding"][torch.from_numpy(items)]
        anchors = users
        if tmodel.mode == "overlap_users":
            pu, qi, anchors = qi, pu, items
        w = Weights(t["transfer.w"], t["transfer.b"], t["unit_attention.w"],
                    t["unit_attention.b"], t["domain_attention.w"], t["domain_attention.b"])
        ops.reset_launch_counts()
        got = natr_attention(history, torch.from_numpy(anchors.astype(np.int32)), pu, qi, w)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS_TOL)
        got.backward(torch.from_numpy(g))
        for name in TARGET_PARAMS:
            np.testing.assert_allclose(t[name].grad.numpy(), _jax_grad(want_g, name),
                                       err_msg=name, **GRAD_TOL)
        assert ops.launch_counts()["natr_attention_forward"] == 0  # plain on the CPU
    finally:
        jmodel.max_inter_length, jmodel._history, jmodel._hist_mask = saved


def _batch(train_data, phase):
    train_data.set_mode(jax_mode2state[phase])
    batch = next(iter(train_data))
    train_data.source_batcher.pr = train_data.target_batcher.pr = 0
    train_data.overlap_batcher.pr = 0
    return batch


@pytest.mark.parametrize("phase", ["SOURCE", "TARGET"])
def test_natr_loss_and_grads_match_jax(pair, phase):
    """Every parameter the phase trains; in TARGET the port's source tables
    get no gradient (B9 reads them detached), where JAX's is masked out."""
    jmodel, tmodel, params = pair["jmodel"], pair["tmodel"], pair["params"]
    batch = _batch(pair["jtrain"], phase)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(phase)(p, b, None)
    ))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss_fn(phase)(_tbatch(batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LOSS_TOL)
    grads = _grads(tmodel)
    pred = tmodel.trainable_predicate(phase)
    trained = [n for n in grads if pred(n.split(".", 1)[0])]
    assert sorted(trained) == sorted(SOURCE_PARAMS if phase == "SOURCE" else TARGET_PARAMS)
    for name in trained:
        np.testing.assert_allclose(grads[name].numpy(), _jax_grad(jgrads, name),
                                   err_msg=name, **GRAD_TOL)
    assert all(grads[n] is None for n in grads if n not in trained)


def test_predict_fallback_matches_jax(pair):
    """The target phase's full-sort scores through the predict fallback
    against JAX's ``make_predict_full_sort``: one B9 full-sort call per
    user tile, the evaluator's pair-cost tile of ``user_batch`` rows."""
    jmodel, tmodel, params = pair["jmodel"], pair["tmodel"], pair["params"]
    item_num = pair["ttest"].item_num
    users = np.arange(1, 41)
    jmodel.set_phase("TARGET")
    want = np.asarray(jax_predict_full_sort(jmodel, "TARGET", item_num)(params, jnp.asarray(users)))
    tmodel.set_phase("TARGET")
    assert tmodel.full_sort_fn("TARGET") is None  # the trainer's cue for the fallback
    with pytest.raises(ValueError, match="no full-sort form"):
        tmodel.full_sort(torch.from_numpy(users), "TARGET")
    fs = make_predict_full_sort(tmodel, item_num)
    with torch.no_grad():
        got = fs(torch.from_numpy(users)).numpy()
    assert got.shape == want.shape == (len(users), item_num)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    k = 10
    want_i = np.argsort(-want, axis=1, kind="stable")[:, :k]
    got_i = np.argsort(-got, axis=1, kind="stable")[:, :k]
    ws = np.take_along_axis(want, want_i, 1)
    gap = np.abs(np.diff(ws, axis=1)) > 2e-6
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_i[clear], want_i[clear])

    # the hook's default (pairs through predict, chunk by chunk, the tail
    # chunk clamped) agrees, on the item axis reversed
    items = torch.arange(item_num).flip(0)
    with torch.no_grad():
        grid = tmodel.predict_grid(torch.from_numpy(users), items)
        pairs = CrossDomainRecommender.predict_grid(tmodel, torch.from_numpy(users), items)
    assert grid.shape == pairs.shape == (len(users), item_num)
    torch.testing.assert_close(grid, pairs, rtol=0, atol=2e-6)
    torch.testing.assert_close(grid, torch.from_numpy(got).flip(1), rtol=0, atol=0)

    ev = FullSortEvaluator(pair["tconfig"])
    assert ev._dense_budget(pair["ttest"], fs) == (pair["ttest"].user_batch,
                                                   FullSortEvaluator.HEAVY_SEG_ELEMS)
    ops.reset_launch_counts()
    ev.topk_ids(fs, pair["ttest"], "cpu")
    counts = ops.launch_counts()  # plain on the CPU
    assert counts["natr_anchor_table"] == counts["natr_pair_grid"] == 0


def test_anchor_table_cache(pair, monkeypatch):
    """``predict_grid`` serves every tile of a pass from one anchor table,
    equal to B9's one-call full-sort plain version on the tile's anchors
    (atol 1e-6: the table's batched transfer rounds apart from the tile's);
    an optimizer step and a ``load_state_dict`` each rebuild it, and the
    training step never reads it."""
    model = copy.deepcopy(pair["tmodel"])
    model.set_phase("TARGET")
    model._version_cache.clear()  # a table an earlier test built is no longer counted
    builds = []
    build = natr_module.natr_anchor_table
    monkeypatch.setattr(natr_module, "natr_anchor_table",
                        lambda *a: builds.append(1) or build(*a))
    users, items = torch.arange(1, 41), torch.arange(pair["ttest"].item_num)

    def grid():
        with torch.no_grad():
            return torch.cat([model.predict_grid(users[:16], items),
                              model.predict_grid(users[16:], items)])

    @torch.no_grad()
    def plain():
        U, I = model.target_user_embedding, model.target_item_embedding
        if model.mode == "overlap_items":
            return natr_full_sort_plain(model._history(), users.int(), U[users], I[items],
                                        model._weights(), True)
        return natr_full_sort_plain(model._history(), items.int(), I[items], U[users],
                                    model._weights(), False)

    first = grid()
    assert len(builds) == 1  # two tiles, one table
    torch.testing.assert_close(first, plain(), rtol=0, atol=1e-6)

    step = make_train_step(model, build_optimizer(pair["tconfig"], model.parameters()),
                           model.loss_fn("TARGET"), model.trainable_predicate("TARGET"))
    with monkeypatch.context() as m:
        m.setattr(model, "_anchor_table", lambda: pytest.fail("training read the anchor table"))
        step(_tbatch(_batch(pair["jtrain"], "TARGET")))
    second = grid()
    assert len(builds) == 2
    assert not torch.allclose(first, second)
    torch.testing.assert_close(second, plain(), rtol=0, atol=1e-6)

    model.load_state_dict({k: 1.5 * v for k, v in model.state_dict().items()})
    third = grid()
    assert len(builds) == 3
    assert not torch.allclose(second, third)
    torch.testing.assert_close(third, plain(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("phase", ["SOURCE", "TARGET"])
def test_one_epoch_natr_parameter_match(phase):
    """One epoch of the port's loop (torch Adam, plain K1-K3 and B9) in a
    single-domain phase against JAX's DeviceEpochLoop from the same
    weights, with JAX's shuffle and negative bits through the random
    source."""
    cfg = {"state": "ERROR", "train_batch_size": 1024, "device": "cpu",
           "train_epochs": ["SOURCE:1", "TARGET:1"]}
    base_rng = jax.random.PRNGKey(1)
    jconfig = JaxConfig(model="NATR", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxNATR(jconfig, jdataset)
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    sopt = SingleOptimizer(jconfig)
    tx = sopt.for_phase(jmodel.trainable_predicate(phase), list(params0))
    jl = jax_loop.DeviceEpochLoop(
        getattr(JaxTrainMode, phase), jmodel.loss_fn(phase), tx, jtrain,
        jconfig["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng, donate=False,
    )
    jparams, _, jloss = jl.run_epoch(params0, sopt.init(params0), 0)

    tconfig = CDRConfig(model="NATR", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = NATR(tconfig, tdataset)
    model.load_state_dict(params_from_jax(jax.device_get(params0)))
    step = make_train_step(model, build_optimizer(tconfig, model.parameters()),
                           model.loss_fn(phase), model.trainable_predicate(phase))
    tl = torch_loop.DeviceEpochLoop(
        getattr(TrainMode, phase), step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, JaxRandomSource(base_rng), "cpu",
    )
    assert (tl.steps_per_epoch, tl.seg_steps) == (jl.steps_per_epoch, jl.seg_steps)
    assert tl.steps_per_epoch > 1
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-3, atol=1e-5)
    named = dict(model.named_parameters())
    jparams = jax.device_get(jparams)
    # beta depends on b_s - b_p alone, so domain_attention.b's gradient is 0
    # in exact arithmetic: each package hands Adam its own rounding noise
    # there, and each step moves the bias by at most the learning rate
    bound = float(tconfig["learning_rate"]) * tl.steps_per_epoch
    b0 = float(np.asarray(params0["domain_attention"]["b"])[0])
    for got in (float(named["domain_attention.b"].detach()[0]),
                float(jparams["domain_attention"]["b"][0])):
        assert abs(got - b0) <= bound
    for name in SOURCE_PARAMS + TARGET_PARAMS[:-1]:
        np.testing.assert_allclose(named[name].detach().numpy(), _jax_grad(jparams, name),
                                   rtol=5e-3, atol=1e-5, err_msg=name)


def test_run_recbole_cdr_natr_on_cpu(monkeypatch):
    """SOURCE then TARGET, validated after each phase (the source split's
    compacted item space, then the target), the test pass in the OVERLAP
    scoring state with the best parameters; finite metrics and a GAUC in
    (0, 1). Without ``device: cpu`` and without a card the entry point
    raises."""
    cfg = {"state": "ERROR", "show_progress": False, "device": "cpu",
           "train_batch_size": 1024, "train_epochs": ["SOURCE:1", "TARGET:2"],
           "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]}
    builds = []
    build = natr_module.natr_anchor_table
    monkeypatch.setattr(natr_module, "natr_anchor_table",
                        lambda *a: builds.append(1) or build(*a))
    result = run_recbole_cdr(model="NATR", config_dict=cfg)
    assert len(builds) == 3  # one anchor table per TARGET validation and for the test
    assert result["model"].phase == "OVERLAP"
    for res in (result["test_result"], result["best_valid_result"]):
        assert all(math.isfinite(v) for v in res.values())
        assert 0 < res["gauc"] < 1
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["SOURCE", "TARGET", "TARGET"]
    assert all(math.isfinite(h["loss"]) and "valid_seconds" in h for h in hist)
    # the SOURCE validation ranks the compacted source item space
    assert hist[0]["valid_users"] != hist[1]["valid_users"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_recbole_cdr(model="NATR", config_dict={k: v for k, v in cfg.items()
                                                   if k != "device"})
