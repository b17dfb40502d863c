"""DTCDR (NeuMF and DMF) in the PyTorch port against the JAX model, on the
CPU (where kernel B11's wrappers run their plain versions), on the bundled
ml-1m -> ml-100k pair.

The same weights (``params_from_jax``, whose lists of ``{w, b}`` become
``source_mlp.0.w`` and the like) and, for the epoch, the same random bits go
to both. Tolerances, each with its case:

- the CSR histories: exactly the nonzero columns of JAX's ``_rating_vector``;
- B11's plain version against the dense ``_rating_vector(...) @ table`` and
  its ``jax.vjp``: ``LOSS_TOL`` / ``GRAD_TOL`` (the gather-sum adds a row's
  entries in another order than the matmul);
- loss and every parameter's gradient, dropout 0: ``LOSS_TOL`` /
  ``GRAD_TOL`` (``tests/test_oracle_equivalence.py:31-32``);
- ``predict`` (training and evaluation mode) and the cached ``predict_grid``
  against JAX's ``predict_fn`` and ``make_predict_full_sort``: atol 2e-6 on
  probabilities (the tower tables and the grid's product sum in another
  order than JAX's per-pair logits), as NATR's fallback test;
- one BOTH epoch with JAX's shuffle and negative bits: rtol 5e-3 / atol
  1e-5, the CMF and NATR epoch tests' tolerance.
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
from recbole_cdr_tpu.models.dtcdr import DTCDR as JaxDTCDR
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.trainer.trainer import make_predict_full_sort as jax_predict_full_sort
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.models.dtcdr as dtcdr_module
import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.base import CrossDomainRecommender
from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
from recbole_cdr_tpu_torch.ops.graph_layer import keep_mask
from recbole_cdr_tpu_torch.ops.rating_vector import (
    BIG_PIECES,
    PIECE,
    history_csr,
    history_layout,
    history_tensors,
    rating_vector,
    rating_vector_backward_plain,
    rating_vector_plain,
)
from recbole_cdr_tpu_torch.ops.row_groups import BIG_TERMS, RowPlan, canonical, group_rows
from recbole_cdr_tpu_torch.trainer.trainer import (
    build_optimizer,
    make_predict_full_sort,
    make_train_step,
)
from recbole_cdr_tpu_torch.utils import get_model, init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from test_torch_epoch import JaxRandomSource
from test_torch_model import GRAD_TOL, LOSS_TOL, _tbatch

BASES = ("NeuMF", "DMF")
#: JAX's history attribute of each of the port's CSRs, and its width
_JAX_HISTORIES = {"s_items": ("_s_hist_items", "source_num_items"),
                  "t_items": ("_t_hist_items", "target_num_items"),
                  "s_users": ("_s_hist_users", "source_num_users"),
                  "t_users": ("_t_hist_users", "target_num_users")}


def _models(base, extra=None):
    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", "base_model": base,
           "dropout_prob": 0.0, **(extra or {})}
    jconfig = JaxConfig(model="DTCDR", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxDTCDR(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    tconfig = CDRConfig(model="DTCDR", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, ttest = data_preparation(tconfig, tdataset)
    tmodel = DTCDR(tconfig, tdataset)
    tmodel.load_state_dict(params_from_jax(params))
    return dict(jconfig=jconfig, jmodel=jmodel, params=params, jtrain=jtrain, jtest=jtest,
                tconfig=tconfig, tmodel=tmodel, ttrain=ttrain, ttest=ttest)


@pytest.fixture(scope="module")
def neumf():
    return _models("NeuMF")


@pytest.fixture(scope="module")
def dmf():
    return _models("DMF")


@pytest.fixture(params=BASES)
def pair(request):
    return request.getfixturevalue(request.param.lower())


def _jax_leaf(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return np.asarray(node)


def _batch(train_data):
    batch = next(iter(train_data))
    train_data.source_batcher.pr = train_data.target_batcher.pr = 0
    return batch


def test_get_model_resolves_dtcdr():
    assert get_model("DTCDR") is DTCDR


def test_params_from_jax_walks_lists(pair):
    """Every leaf of JAX's pytree, lists of ``{w, b}`` included, lands on
    the port's parameter of the same dotted name, and nothing is left
    over."""
    params, tmodel = pair["params"], pair["tmodel"]
    converted = params_from_jax(params)
    named = dict(tmodel.named_parameters())
    assert sorted(converted) == sorted(named)
    stack = "source_mlp" if tmodel.base_model == "NeuMF" else "source_user_fc"
    assert {f"{stack}.0.w", f"{stack}.0.b", f"{stack}.1.w"} <= set(converted)
    for name, value in converted.items():
        np.testing.assert_array_equal(named[name].detach().numpy(), _jax_leaf(params, name))
        assert named[name].shape == value.shape
    nested = params_from_jax({"a": [{"w": np.ones(2)}, [np.zeros(1)]]})
    assert sorted(nested) == ["a.0.w", "a.1.0"]


def test_histories_equal_jax_rating_vectors(dmf):
    """Row by row, each CSR holds exactly the nonzero columns of JAX's
    ``_rating_vector`` (deduplicated, PAD zeroed, source ids compacted)."""
    jmodel, tmodel = dmf["jmodel"], dmf["tmodel"]
    rv = jax.jit(jmodel._rating_vector, static_argnums=2)
    for name, (attr, width) in _JAX_HISTORIES.items():
        hist = getattr(jmodel, attr)
        csr = tmodel._csr(name)
        ptr, cols = csr.ptr.numpy(), csr.cols.numpy()
        assert ptr.shape == (hist.shape[0] + 1,) and cols.max() < getattr(jmodel, width)
        for lo in range(0, hist.shape[0], 2048):
            ids = jnp.arange(lo, min(lo + 2048, hist.shape[0]))
            dense = np.asarray(rv(hist, ids, getattr(jmodel, width)))
            rows, nz = np.nonzero(dense)
            want_ptr = np.searchsorted(rows, np.arange(len(ids) + 1))
            np.testing.assert_array_equal(ptr[lo:lo + len(ids) + 1] - ptr[lo], want_ptr,
                                          err_msg=name)
            np.testing.assert_array_equal(cols[ptr[lo]:ptr[lo + len(ids)]], nz, err_msg=name)


def _dense_case(R=40, N=70, H=12):
    """A history of R rows of up to H entries over N table rows with
    duplicates, PAD entries and an empty row, repeated ids in the batch
    (numpy seed 3), and JAX's dense ``_rating_vector(hist, ids, N) @ table``
    with its ``jax.vjp`` of ``g``."""
    rng = np.random.default_rng(3)
    D, B = 16, 300
    hist = rng.integers(0, N, (R, H))
    hist[:, 1] = hist[:, 0]       # duplicates
    hist[::3, 2:5] = 0            # PAD
    hist[5] = 0                   # an empty row
    lens = rng.integers(0, H + 1, R)
    hist = np.where(np.arange(H)[None, :] < lens[:, None], hist, 0)
    ids = rng.integers(0, R, B)
    ids[:4] = 5
    table = rng.normal(size=(N, D)).astype(np.float32)
    g = rng.normal(size=(B, D)).astype(np.float32)

    def dense(t):
        vec = jnp.zeros((B, N)).at[jnp.repeat(jnp.arange(B), H), jnp.asarray(hist[ids]).reshape(-1)].set(1.0)
        return vec.at[:, 0].set(0.0) @ t

    want, vjp = jax.vjp(dense, jnp.asarray(table))
    (want_g,) = vjp(jnp.asarray(g))
    ptr, cols = history_csr(np.repeat(np.arange(R), H), hist.reshape(-1), R)
    return dict(R=R, N=N, ids=ids, table=table, g=g, want=np.asarray(want),
                want_g=np.asarray(want_g), ptr=ptr, cols=cols)


def test_rating_vector_plain_matches_dense_form():
    """B11's plain forward and backward, through the autograd function on
    CPU tensors, against JAX's dense ``_rating_vector(hist, ids, N) @
    table`` and its ``jax.vjp`` (``_dense_case``)."""
    case = _dense_case()
    N, ids, table, g = case["N"], case["ids"], case["table"], case["g"]
    want, want_g, ptr, cols = case["want"], case["want_g"], case["ptr"], case["cols"]
    csr = history_tensors(ptr, cols, N)
    t = torch.from_numpy(table).requires_grad_()
    tid = torch.from_numpy(ids.astype(np.int32))
    ops.reset_launch_counts()
    got = rating_vector(csr, t, tid, group_rows(tid, RowPlan(case["R"], "cpu")))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS_TOL)
    np.testing.assert_array_equal(got[:4].detach().numpy(), 0.0)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), **GRAD_TOL)
    torch.testing.assert_close(rating_vector_backward_plain(csr, N, tid, torch.from_numpy(g)),
                               t.grad, rtol=0, atol=0)
    torch.testing.assert_close(rating_vector_plain(csr, t.detach(), tid), got.detach(),
                               rtol=0, atol=0)
    counts = ops.launch_counts()  # plain on the CPU
    assert counts["rating_vector_forward"] == counts["rating_vector_backward"] == 0


def test_transposed_gradient_matches_dense_form():
    """The backward as the kernels walk it, in torch: each id's gradient
    summed per history row, then each table row's sum over the rows of its
    transposed history (``history_layout``), against JAX's ``vec.T @ gout``
    (``GRAD_TOL``), on 200 rows of up to 140 entries over 170 table rows; the
    layout's pieces cover exactly the entries of the rows of more than
    ``PIECE`` entries, ``PIECE`` at a time."""
    case = _dense_case(200, 170, 140)
    R, N, ptr, cols = case["R"], case["N"], case["ptr"], case["cols"]
    layout = history_layout(ptr, cols, N)
    g_rows = torch.zeros(R, case["g"].shape[1]).index_add_(
        0, torch.from_numpy(case["ids"]), torch.from_numpy(case["g"]))
    owner = torch.repeat_interleave(torch.arange(N), torch.from_numpy(np.diff(layout.tptr)).long())
    got = torch.zeros(N, g_rows.shape[1]).index_add_(0, owner, g_rows[layout.tcols])
    np.testing.assert_allclose(got.numpy(), case["want_g"], **GRAD_TOL)
    for p_row, p_first, big, small, rptr in ((*layout[:4], ptr), (*layout[6:], layout.tptr)):
        lens = np.diff(rptr)
        assert set(big) | set(small) == set(np.flatnonzero(lens > PIECE)) and len(small) > 0
        np.testing.assert_array_equal(np.diff(p_first), -(-lens // PIECE) * (lens > PIECE))
        np.testing.assert_array_equal(np.bincount(p_row, minlength=len(lens)), np.diff(p_first))
        assert (np.diff(p_first)[big] > BIG_PIECES).all()
        assert (np.diff(p_first)[small] <= BIG_PIECES).all()


def test_transposed_histories_equal_jax(dmf):
    """Each history's transpose (``{name}_tptr`` / ``{name}_tcols``): for
    every table row, the rows of JAX's padded history matrix that hold it
    (PAD and duplicates out), in increasing order."""
    jmodel, tmodel = dmf["jmodel"], dmf["tmodel"]
    for name, (attr, width) in _JAX_HISTORIES.items():
        hist = np.asarray(getattr(jmodel, attr)).astype(np.int64)
        R, N = hist.shape[0], getattr(jmodel, width)
        rows, cols = np.repeat(np.arange(R), hist.shape[1]), hist.reshape(-1)
        keys = np.unique(cols[cols != 0] * R + rows[cols != 0])
        want_ptr = np.searchsorted(keys // R, np.arange(N + 1))
        np.testing.assert_array_equal(getattr(tmodel, f"{name}_tptr").numpy(), want_ptr,
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(tmodel, f"{name}_tcols").numpy(), keys % R,
                                      err_msg=name)


def test_dmf_grouping_from_group_rows(dmf, monkeypatch):
    """The grouping DMF builds for B11 (one ``group_rows`` call for both
    sides' ids, duplicates, PAD 0 and one id at more than ``BIG_TERMS``
    positions among them): every id's positions in ascending order, that id
    the one big head, and B11 from it equal to its plain version exactly."""
    model = dmf["tmodel"]
    rng = np.random.default_rng(5)
    ids = {"user": rng.integers(0, model.total_num_users, 300).astype(np.int32),
           "item": rng.integers(0, model.total_num_items, 300).astype(np.int32)}
    for side in ids.values():
        side[:BIG_TERMS + 36], side[BIG_TERMS + 36] = 7, 0
    calls = []
    real = dtcdr_module.group_rows
    monkeypatch.setattr(dtcdr_module, "group_rows",
                        lambda *a, **kw: calls.append(real(*a, **kw)) or calls[-1])
    with torch.no_grad():
        user_e, item_e = model._dmf_embeddings(torch.from_numpy(ids["user"]),
                                               torch.from_numpy(ids["item"]))
    assert len(calls) == 1 and len(calls[0]) == 2
    for (side, names), groups, got in zip(
            (("user", ("s_items", "t_items")), ("item", ("s_users", "t_users"))), calls[0],
            (user_e, item_e)):
        x = ids[side]
        rows, lens, pos = canonical(groups)
        heads, counts = np.unique(x, return_counts=True)
        np.testing.assert_array_equal(rows.numpy(), heads)
        np.testing.assert_array_equal(lens.numpy(), counts)
        np.testing.assert_array_equal(pos.numpy(), np.argsort(x, kind="stable"))
        big = groups.big[:int(groups.meta[2])].long()
        assert groups.head_row[big].tolist() == [7]
        tid = torch.from_numpy(x)
        want = []
        for name in names:
            table = getattr(model, dtcdr_module._TABLES[name]).detach()
            plain = rating_vector_plain(model._csr(name), table, tid)
            torch.testing.assert_close(rating_vector(model._csr(name), table, tid, groups),
                                       plain, rtol=0, atol=0)
            want.append(plain)
        torch.testing.assert_close(got, torch.maximum(*want), rtol=0, atol=0)


def test_dmf_keeps_one_row_plan_per_side(dmf):
    """DMF keeps two ``RowPlan``s, users' and items' rows, made on its first
    loss and reused by the next (each loss groups both sides once); a deep
    copy of the model carries plans of the same rows."""
    model = copy.deepcopy(dmf["tmodel"])
    model.__dict__.pop("_dmf_plans", None)  # a fresh model: the fixture's is shared
    batch = _tbatch(_batch(dmf["jtrain"]))
    model.loss(batch)
    (dev, plans), = model.__dict__["_dmf_plans"].items()
    model.loss(batch)
    (dev2, plans2), = model.__dict__["_dmf_plans"].items()
    assert dev == dev2 == torch.device("cpu")
    assert plans2[0] is plans[0] and plans2[1] is plans[1]
    assert [p.L for p in plans] == [model.total_num_users, model.total_num_items]
    assert [p.generation for p in plans] == [2, 2]
    copied = copy.deepcopy(model)
    (dev3, plans3), = copied.__dict__["_dmf_plans"].items()
    assert dev3 == dev
    assert [isinstance(p, RowPlan) for p in plans3] == [True, True]
    assert all(a is not b for a, b in zip(plans3, plans))
    assert [(p.L, p.offset) for p in plans3] == [(p.L, p.offset) for p in plans]


def test_rating_vector_rejects_a_foreign_grouping():
    """B11 takes only the grouping of its own ids over its history's rows:
    another ids count, another row count, a shard's offset or an object
    that is no grouping raise before any work."""
    case = _dense_case()
    csr = history_tensors(case["ptr"], case["cols"], case["N"])
    tid, t = torch.from_numpy(case["ids"].astype(np.int32)), torch.from_numpy(case["table"])
    R = case["R"]
    assert torch.equal(rating_vector(csr, t, tid, group_rows(tid, RowPlan(R, "cpu"))),
                       rating_vector_plain(csr, t, tid))
    for groups in (group_rows(tid[:-1], RowPlan(R, "cpu")), group_rows(tid, RowPlan(R + 1, "cpu")),
                   group_rows(tid, RowPlan(R, "cpu", offset=1))):
        with pytest.raises(ValueError, match="grouping"):
            rating_vector(csr, t, tid, groups)
    with pytest.raises(TypeError, match="Groups"):
        rating_vector(csr, t, tid, None)


def test_dtcdr_loss_and_grads_match_jax(pair):
    """Dropout 0: the BOTH loss and every parameter's gradient."""
    jmodel, tmodel, params = pair["jmodel"], pair["tmodel"], pair["params"]
    batch = _batch(pair["jtrain"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn("BOTH")(p, b, None)
    ))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss_fn("BOTH")(_tbatch(batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LOSS_TOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _jax_leaf(jgrads, name), err_msg=name,
                                   **GRAD_TOL)


def test_neumf_dropout_mask_from_bits(neumf):
    """NeuMF's training dropout: each layer's mask is ``keep_mask`` of the
    bits the step's ``rng(layer, domain, shape)`` hands it, kept entries
    scaled by 1 / keep; over 2^16 random bits the drop rate is
    ``dropout_prob`` within 1%."""
    model = copy.deepcopy(neumf["tmodel"])
    model.dropout_prob = 0.25
    keep = 0.75
    gen = torch.Generator().manual_seed(0)
    draws = []

    def rng(layer, domain, shape):
        bits = torch.randint(-2 ** 31, 2 ** 31, tuple(shape), dtype=torch.int32, generator=gen)
        draws.append((layer, domain, bits))
        return bits

    x = torch.rand(256, 2 * model.embedding_size) + 0.5
    got = model._mlp(model.source_mlp, x, rng, "source")
    assert [(layer, domain) for layer, domain, _ in draws] == [(0, "source"), (1, "source")]
    h = x
    for (_, _, bits), layer in zip(draws, model.source_mlp):
        mask = keep_mask(bits, keep)
        h = torch.relu(layer(torch.where(mask, h / keep, 0.0)))
    torch.testing.assert_close(got, h, rtol=0, atol=0)
    # the first layer's input: kept units scaled by 1 / keep, the rest 0
    probe = []
    handle = model.source_mlp[0].register_forward_pre_hook(lambda mod, args: probe.append(args[0]))
    try:
        draws.clear()
        model._mlp(model.source_mlp, x, rng, "source")
    finally:
        handle.remove()
    mask = keep_mask(draws[0][2], keep)
    torch.testing.assert_close(probe[0][mask], x[mask] / keep, rtol=0, atol=0)
    assert not bool(probe[0][~mask].any())
    bits = torch.randint(-2 ** 31, 2 ** 31, (1 << 16,), dtype=torch.int32, generator=gen)
    assert abs(1.0 - float(keep_mask(bits, keep).float().mean()) - 0.25) < 0.01
    # without the step's bits no unit drops
    h = x
    for layer in model.source_mlp:
        h = torch.relu(layer(h))
    torch.testing.assert_close(model._mlp(model.source_mlp, x), h, rtol=0, atol=0)


def test_predict_and_grid_match_jax(pair):
    """``predict`` in training mode (B11 per pair) and in evaluation mode
    (the tower tables), and the fallback's grid, against JAX's
    ``predict_fn`` and ``make_predict_full_sort`` from the same weights;
    ``predict_grid`` equals the default chunked grid over ``predict``."""
    jmodel, params = pair["jmodel"], pair["params"]
    tmodel = copy.deepcopy(pair["tmodel"])
    item_num = pair["ttest"].item_num
    rng = np.random.default_rng(5)
    users = rng.integers(0, tmodel.target_num_users, 300)
    items = rng.integers(0, item_num, 300)
    uid, iid = tmodel.TARGET_USER_ID, tmodel.TARGET_ITEM_ID
    want = np.asarray(jmodel.predict_fn()(params, {uid: jnp.asarray(users), iid: jnp.asarray(items)}))
    batch = {uid: torch.from_numpy(users), iid: torch.from_numpy(items)}
    with torch.no_grad():
        tmodel.train()
        np.testing.assert_allclose(tmodel.predict(batch).numpy(), want, rtol=0, atol=2e-6)
        tmodel.eval()
        np.testing.assert_allclose(tmodel.predict(batch).numpy(), want, rtol=0, atol=2e-6)

    assert tmodel.full_sort_fn("TARGET") is None  # the trainer's cue for the fallback
    assert tmodel.full_sort_factors("TARGET") is None
    grid_users = np.arange(1, 41)
    want = np.asarray(jax_predict_full_sort(jmodel, "TARGET", item_num)(params, jnp.asarray(grid_users)))
    with torch.no_grad():
        got = make_predict_full_sort(tmodel, item_num)(torch.from_numpy(grid_users)).numpy()
        pairs = CrossDomainRecommender.predict_grid(tmodel, torch.from_numpy(grid_users),
                                                    torch.arange(item_num))
    assert got.shape == want.shape == (len(grid_users), item_num)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(torch.from_numpy(got), pairs, rtol=0, atol=2e-6)


def test_tower_tables_cached_per_version(dmf, monkeypatch):
    """One tower table per parameter version: two grid tiles and the
    candidate path's predictions share one build (four B11 calls); an
    optimizer step and a ``load_state_dict`` each rebuild it; training
    never reads it."""
    model = copy.deepcopy(dmf["tmodel"])
    model.eval()
    calls = []
    real = dtcdr_module.rating_vector
    monkeypatch.setattr(dtcdr_module, "rating_vector", lambda *a: calls.append(1) or real(*a))
    users, items = torch.arange(1, 41), torch.arange(model.target_num_items)
    uid, iid = model.TARGET_USER_ID, model.TARGET_ITEM_ID

    def score():
        with torch.no_grad():
            grid = torch.cat([model.predict_grid(users[:16], items),
                              model.predict_grid(users[16:], items)])
            pairs = model.predict({uid: users.repeat_interleave(3), iid: items[:3].repeat(40)})
        return grid, pairs

    first, pairs = score()
    assert len(calls) == 4
    torch.testing.assert_close(pairs, first[:, :3].reshape(-1), rtol=0, atol=0)

    model.train()
    step = make_train_step(model, build_optimizer(dmf["tconfig"], model.parameters()),
                           model.loss_fn("BOTH"), lambda n: True)
    with monkeypatch.context() as m:
        m.setattr(model, "_tower_tables", lambda: pytest.fail("training read the tower tables"))
        step(_tbatch(_batch(dmf["jtrain"])))
    assert len(calls) == 8  # one training step: one launch per table
    model.eval()
    second, _ = score()
    assert len(calls) == 12 and not torch.allclose(first, second)
    model.load_state_dict({k: 1.5 * v for k, v in model.state_dict().items()})
    third, _ = score()
    assert len(calls) == 16 and not torch.allclose(second, third)


@pytest.mark.parametrize("base", BASES)
def test_one_epoch_dtcdr_parameter_match(base):
    """One BOTH epoch of the port's loop (torch Adam, plain K2, K3 and B11)
    against JAX's DeviceEpochLoop from the same weights, with JAX's shuffle
    and negative bits through the random source; dropout 0."""
    cfg = {"state": "ERROR", "train_batch_size": 2048, "device": "cpu", "base_model": base,
           "dropout_prob": 0.0, "train_epochs": ["BOTH:1"]}
    base_rng = jax.random.PRNGKey(1)
    jconfig = JaxConfig(model="DTCDR", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxDTCDR(jconfig, jdataset)
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    sopt = SingleOptimizer(jconfig)
    tx = sopt.for_phase(lambda k: True, list(params0))
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), tx, jtrain, jconfig["MODEL_INPUT_TYPE"], 1,
        jmodel.total_num_users, base_rng, donate=False,
    )
    jparams, _, jloss = jl.run_epoch(params0, sopt.init(params0), 0)

    tconfig = CDRConfig(model="DTCDR", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = DTCDR(tconfig, tdataset)
    model.load_state_dict(params_from_jax(jax.device_get(params0)))
    step = make_train_step(model, build_optimizer(tconfig, model.parameters()),
                           model.loss_fn("BOTH"), lambda n: True)
    tl = torch_loop.DeviceEpochLoop(
        TrainMode.BOTH, step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, JaxRandomSource(base_rng), "cpu",
    )
    assert (tl.steps_per_epoch, tl.seg_steps) == (jl.steps_per_epoch, jl.seg_steps)
    assert tl.steps_per_epoch > 1
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-3, atol=1e-5)
    jparams = jax.device_get(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _jax_leaf(jparams, name),
                                   rtol=5e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("base", BASES)
def test_run_recbole_cdr_dtcdr_on_cpu(base, monkeypatch):
    """BOTH:2 at the published widths with dropout, validated every epoch
    through the predict fallback, the test pass with the best parameters:
    finite metrics, GAUC in (0, 1); DMF builds one tower table per
    validation and for the test."""
    cfg = {"state": "ERROR", "show_progress": False, "device": "cpu", "base_model": base,
           "train_batch_size": 2048, "train_epochs": ["BOTH:2"],
           "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]}
    builds = []
    real = DTCDR._tower_tables
    monkeypatch.setattr(DTCDR, "_tower_tables", lambda self: builds.append(
        self.params_version) or real(self))
    result = run_recbole_cdr(model="DTCDR", config_dict=cfg)
    assert len(set(builds)) == 3  # two validations and the test
    for res in (result["test_result"], result["best_valid_result"]):
        assert all(math.isfinite(v) for v in res.values())
        assert 0 < res["gauc"] < 1
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["BOTH", "BOTH"]
    assert all(math.isfinite(h["loss"]) and "valid_seconds" in h for h in hist)
