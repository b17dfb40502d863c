"""DCDCSR in the PyTorch port against the JAX model, on the CPU (where kernel
B12's and K1's wrappers run their plain versions), on the bundled ml-1m ->
ml-100k pair (overlapped items) and on ``tests/test_user_overlap.py``'s pair
(overlapped users).

The same weights (``params_from_jax``, the derived benchmark and affine
tables included) and batches go to both. Tolerances, each with its case:

- B12 (``_build_benchmark``): rows within 1e-5 + 1e-5·|x| wherever the
  k-th and (k+1)-th similarity of the row differ by more than 1e-5 (nearer
  ties may order differently under the two matmuls' rounding), the
  overlapped rows and the all-zero rows (every similarity exactly 0: the tie
  rule gives ids 0..k-1) everywhere, NaN where JAX has NaN; the top-k ids
  equal to ``lax.top_k``'s as sets under the same gap rule and position by
  position on the all-zero rows;
- the affine table (TARGET#2 surgery): rtol 1e-5, atol 1e-6 (one tanh MLP
  in float32);
- loss and gradients of every phase: ``LOSS_TOL`` / ``GRAD_TOL``
  (``tests/test_oracle_equivalence.py:31-32``);
- one epoch of Adam (device-path SOURCE with JAX's bits, host-path BOTH):
  rtol 5e-3 / atol 1e-5, the CMF epoch test's tolerance; ``map_sample_idx``
  bit-equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.models.dcdcsr import DCDCSR as JaxDCDCSR
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.dcdcsr import DCDCSR
from recbole_cdr_tpu_torch.ops.benchmark_topk import MAX_K, benchmark_topk, benchmark_topk_plain
from recbole_cdr_tpu_torch.trainer import CrossDomainTrainer, DCDCSRTrainer
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import get_trainer, init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import InputType, TrainMode
from test_torch_epoch import JaxRandomSource
from test_torch_model import GRAD_TOL, LOSS_TOL, _tbatch
from test_torch_natr import _user_overlap_cfg
from test_user_overlap import pair_root  # noqa: F401  (fixture)

EPOCH_TOL = dict(rtol=5e-3, atol=1e-5)
#: B12's tolerance: rows (atol, rtol), and the similarity gap below which the
#: k-th and (k+1)-th may swap
B12_TOL, B12_GAP = (1e-5, 1e-5), 1e-5
SCHEDULE = ("SOURCE", "TARGET", "BOTH", "TARGET")


def build_pair(name, jax_cls, torch_cls, extra=None, params_fn=None):
    """The JAX and the port's model ``name`` on one config, the port's
    loaded with the JAX model's initial parameters (``params_fn(jmodel,
    params)`` may replace them first)."""
    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", **(extra or {})}
    jconfig = JaxConfig(model=name, config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = jax_cls(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    if params_fn is not None:
        params = params_fn(jmodel, params)
    tconfig = CDRConfig(model=name, config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, ttest = data_preparation(tconfig, tdataset)
    tmodel = torch_cls(tconfig, tdataset)
    tmodel.load_state_dict(params_from_jax(params))
    return dict(jconfig=jconfig, jdataset=jdataset, jmodel=jmodel, params=params,
                jtrain=jtrain, jtest=jtest, tconfig=tconfig, tmodel=tmodel, ttrain=ttrain,
                ttest=ttest)


def phase_batch(train_data, phase):
    """The JAX loader's first batch in ``phase``, pointers left at 0."""
    train_data.set_mode(JaxTrainMode[phase])
    batch = next(iter(train_data))
    for b in (train_data.source_batcher, train_data.target_batcher,
              train_data.overlap_batcher):
        b.pr = 0
    return batch


def jax_leaf(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return np.asarray(node)


def assert_loss_and_grads_match(jmodel, params, tmodel, phase, batch):
    """The phase's loss on ``batch`` and every parameter's gradient:
    ``LOSS_TOL`` / ``GRAD_TOL``; a parameter the port's loss leaves without
    a gradient has JAX's gradient 0."""
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(phase)(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                        None))(params)
    tmodel.zero_grad(set_to_none=True)
    tloss = tmodel.loss_fn(phase)(_tbatch(batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), err_msg=phase, **LOSS_TOL)
    for name, p in tmodel.named_parameters():
        want = jax_leaf(jgrads, name)
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"{phase} {name}", **GRAD_TOL)
    return float(jloss)


def _zero_and_tie_rows(jmodel, params):
    """Random tables of the model's shapes with all-zero rows of the
    benchmark's ``rest`` part, exact duplicates among the overlapped source
    rows (ties at non-zero similarities), and rows whose every similarity
    is negative (the overlapped source rows share a positive first column)."""
    rng = np.random.default_rng(11)
    ent = "user" if jmodel.mode == "overlap_users" else "item"
    n_ov = jmodel.overlapped_num_users if ent == "user" else jmodel.overlapped_num_items
    n_total = jmodel.total_num_users if ent == "user" else jmodel.total_num_items
    params = dict(params)
    tgt = rng.normal(0, 0.3, np.shape(params[f"target_{ent}_embedding"])).astype(np.float32)
    src = rng.normal(0, 0.3, np.shape(params[f"source_{ent}_embedding"])).astype(np.float32)
    zero = rng.choice(np.arange(n_ov, n_total), size=max(1, (n_total - n_ov) // 4),
                      replace=False)
    tgt[zero] = 0.0
    src[1:n_ov:7] = src[1]
    src[:n_ov, 0] += 1.0
    negative = np.setdiff1d(np.arange(n_ov, n_total), zero)[::5]
    tgt[negative] = 0.0
    tgt[negative, 0] = -2.0
    params[f"target_{ent}_embedding"] = tgt
    params[f"source_{ent}_embedding"] = src
    return params


def _pair(mode, root=None, params_fn=None, extra=None):
    extra = {**(_user_overlap_cfg(root) if mode == "overlap_users" else {}), **(extra or {})}
    m = build_pair("DCDCSR", JaxDCDCSR, DCDCSR, extra, params_fn)
    assert m["jmodel"].mode == m["tmodel"].mode == mode
    return m


@pytest.fixture(params=["overlap_items", "overlap_users"])
def mode_root(request):
    root = request.getfixturevalue("pair_root") if request.param == "overlap_users" else None
    return request.param, root


def _bench_inputs(model):
    ent = "user" if model.mode == "overlap_users" else "item"
    n_ov = getattr(model, f"overlapped_num_{ent}s")
    n_total = getattr(model, f"total_num_{ent}s")
    rest = getattr(model, f"target_{ent}_embedding").detach()[n_ov:n_total]
    src = getattr(model, f"source_{ent}_embedding").detach()[:n_ov]
    return rest, src, n_ov, min(model.k, n_ov)


def assert_benchmark_close(got, want, model):
    """B12's tolerance on a whole [n_total, D] benchmark table."""
    rest, src, n_ov, k = _bench_inputs(model)
    atol, rtol = B12_TOL
    np.testing.assert_allclose(got[:n_ov], want[:n_ov], atol=atol, rtol=rtol)
    sims = np.sort(rest.double().numpy() @ src.double().numpy().T, axis=1)[:, ::-1]
    gap = sims[:, k - 1] - sims[:, k] if n_ov > k else np.full(len(rest), np.inf)
    zero = (rest == 0).all(1).numpy()
    assert zero.any()
    clear = (gap > B12_GAP) | zero
    assert clear.mean() > 0.5, clear.mean()
    np.testing.assert_allclose(got[n_ov:][clear], want[n_ov:][clear], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name,extra", [("DCDCSR", {}), ("EMCDR", {}),
                                        ("EMCDR", {"mapping_function": "linear"}),
                                        ("SSCDR", {})])
def test_params_from_jax_covers_every_entry(name, extra):
    """Every leaf of the JAX tree, mapping MLP lists and DCDCSR's derived
    tables (after the surgeries, at their grown shapes) included, lands on
    the port's state dict entry of the same dotted name, and nothing is
    left over."""
    from recbole_cdr_tpu.models.emcdr import EMCDR as JaxEMCDR
    from recbole_cdr_tpu.models.sscdr import SSCDR as JaxSSCDR

    from recbole_cdr_tpu_torch.models.emcdr import EMCDR
    from recbole_cdr_tpu_torch.models.sscdr import SSCDR

    classes = {"DCDCSR": (JaxDCDCSR, DCDCSR), "EMCDR": (JaxEMCDR, EMCDR),
               "SSCDR": (JaxSSCDR, SSCDR)}[name]

    def grown(jmodel, params):
        if name != "DCDCSR":
            return params
        for phase in SCHEDULE:
            jmodel.set_phase(phase)
            params = jax.device_get(jmodel.mutate_params_on_phase(params, phase))
        return params

    m = build_pair(name, *classes, extra, params_fn=grown)
    state = m["tmodel"].state_dict()
    converted = params_from_jax(m["params"])
    assert sorted(converted) == sorted(state)
    for key, value in converted.items():
        np.testing.assert_array_equal(state[key].numpy(), value.numpy(), err_msg=key)
    if name == "DCDCSR":
        assert state["benchmark_embedding"].shape[0] == m["tmodel"].total_num_items
        assert state["affine_embedding"].shape[0] == m["tmodel"].target_num_items


def test_get_trainer_resolves_the_model_trainer():
    assert get_trainer(None, "DCDCSR") is DCDCSRTrainer
    assert get_trainer(None, "EMCDR") is CrossDomainTrainer
    assert get_trainer(None, "CMF") is CrossDomainTrainer


def test_popularity_equals_jax(mode_root):
    m = _pair(*mode_root)
    np.testing.assert_array_equal(m["tmodel"]._source_pop.numpy(),
                                  np.asarray(m["jmodel"]._source_pop))
    np.testing.assert_array_equal(m["tmodel"]._target_pop.numpy(),
                                  np.asarray(m["jmodel"]._target_pop))


def test_benchmark_matches_jax(mode_root):
    """The port's ``_build_benchmark`` (B12's plain version for the rest)
    against ``jax.jit(_build_benchmark)`` on tables with all-zero rows,
    exact ties and similarities of both signs."""
    m = _pair(*mode_root, params_fn=_zero_and_tie_rows)
    want = np.asarray(jax.jit(m["jmodel"]._build_benchmark)(m["params"]))
    got = m["tmodel"]._build_benchmark().numpy()
    assert got.shape == want.shape
    assert_benchmark_close(got, want, m["tmodel"])


def test_b12_ids_follow_lax_top_k(mode_root):
    """The plain version's ids and similarities against ``lax.top_k`` of
    JAX's product: ties to the lower index (the all-zero rows give 0..k-1)."""
    m = _pair(*mode_root, params_fn=_zero_and_tie_rows)
    tmodel = m["tmodel"]
    rest, src, n_ov, k = _bench_inputs(tmodel)
    s_pop, t_pop = tmodel._source_pop, tmodel._target_pop
    n_total = n_ov + rest.shape[0]
    _, idx, sim = benchmark_topk(rest, src, s_pop[:n_ov], t_pop[n_ov:n_total], k)
    jsim, jidx = jax.lax.top_k(jnp.asarray(rest.numpy()) @ jnp.asarray(src.numpy()).T, k)
    jidx, jsim = np.asarray(jidx), np.asarray(jsim)
    zero = (rest == 0).all(1).numpy()
    np.testing.assert_array_equal(idx.numpy()[zero], np.broadcast_to(np.arange(k), jidx[zero].shape))
    np.testing.assert_array_equal(jidx[zero], idx.numpy()[zero])
    sims = np.sort(rest.double().numpy() @ src.double().numpy().T, axis=1)[:, ::-1]
    clear = sims[:, k - 1] - sims[:, k] > B12_GAP
    np.testing.assert_array_equal(np.sort(idx.numpy()[clear], 1), np.sort(jidx[clear], 1))
    np.testing.assert_allclose(sim.numpy(), jsim, atol=B12_TOL[0], rtol=B12_TOL[1])
    assert (jsim < 0).all(1).any()  # rows whose top k are all negative


def test_b12_plain_keeps_nan_and_rejects_large_k():
    """JAX's formula unchanged where ``sn + t_pop`` is 0 (0 / 0 = NaN), and
    k above the kernel's cap raises."""
    rest = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    src = torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, -1.0]])
    s_pop = torch.tensor([0.0, 0.0, 3.0])
    t_pop = torch.tensor([4.0, 0.0])
    out, idx, sim = benchmark_topk_plain(rest, src, s_pop, t_pop, 2)
    np.testing.assert_array_equal(idx.numpy(), [[2, 1], [1, 0]])
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    with pytest.raises(ValueError, match="k <="):
        benchmark_topk(torch.zeros(2, 4), torch.zeros(MAX_K + 1, 4), torch.zeros(MAX_K + 1),
                       torch.zeros(2), MAX_K + 1)


def test_schedule_losses_grads_and_surgeries_match_jax(mode_root):
    """Every phase of the schedule, the second TARGET included: the phase
    entry surgeries tensor for tensor, then the loss and gradients on one
    batch (BOTH's with the JAX model's ``map_sample_idx``)."""
    m = _pair(*mode_root)
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    for phase in SCHEDULE:
        jmodel.set_phase(phase)
        params = jax.device_get(jmodel.mutate_params_on_phase(params, phase))
        tmodel.set_phase(phase)
        tmodel.mutate_params_on_phase(phase)
        assert tmodel.phase2count == jmodel.phase2count
        if phase == "BOTH":
            assert_benchmark_close(tmodel.benchmark_embedding.numpy(),
                                   np.asarray(params["benchmark_embedding"]), tmodel)
        if phase == "TARGET" and tmodel.phase2count["TARGET"] == 2:
            np.testing.assert_allclose(tmodel.affine_embedding.numpy(),
                                       np.asarray(params["affine_embedding"]),
                                       rtol=1e-5, atol=1e-6)
        batch = jmodel.augment_batch(phase_batch(m["jtrain"], phase), phase)
        assert_loss_and_grads_match(jmodel, params, tmodel, phase, batch)
    # the final scoring state (OVERLAP: the affine table) scores as JAX's
    users = jnp.arange(1, 30)
    for phase in ("TARGET", "OVERLAP"):
        np.testing.assert_allclose(tmodel.full_sort(torch.arange(1, 30), phase).detach().numpy(),
                                   np.asarray(jmodel.full_sort_fn(phase)(params, users)),
                                   rtol=1e-5, atol=1e-6)


def test_one_epoch_source_parameter_match():
    """A device-path phase: one SOURCE epoch on the pairwise stream (JAX's
    shuffle and negative bits) through K1's plain version and torch Adam."""
    m = _pair("overlap_items")
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    base_rng = jax.random.PRNGKey(3)
    for model in (jmodel, tmodel):
        model.set_phase("SOURCE")
    sopt = SingleOptimizer(m["jconfig"])
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.SOURCE, jmodel.loss_fn("SOURCE"),
        sopt.for_phase(jmodel.trainable_predicate("SOURCE"), list(params)), m["jtrain"],
        m["jconfig"]["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng, donate=False)
    jparams, _, jloss = jl.run_epoch(params, sopt.init(params), 0)
    step = make_train_step(tmodel, build_optimizer(m["tconfig"], tmodel.parameters()),
                           tmodel.loss_fn("SOURCE"), tmodel.trainable_predicate("SOURCE"))
    tl = torch_loop.DeviceEpochLoop(TrainMode.SOURCE, step, m["ttrain"], InputType.PAIRWISE,
                                    1, tmodel.total_num_users, JaxRandomSource(base_rng), "cpu")
    assert (tl.steps_per_epoch, tl.seg_steps) == (jl.steps_per_epoch, jl.seg_steps) >= (3, 3)
    np.testing.assert_allclose(float(tl.run_epoch(0)), float(jloss), **EPOCH_TOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jparams, name),
                                   err_msg=name, **EPOCH_TOL)


def test_one_epoch_host_both_parameter_match():
    """The host-path BOTH phase through ``DCDCSRTrainer.fit``: the benchmark
    built on entry, every loader batch augmented with a ``map_sample_idx``
    bit-equal to JAX's, one Adam step per batch."""
    m = _pair("overlap_items", extra={"train_epochs": ["BOTH:1"]})
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    jmodel.set_phase("BOTH")
    params = jmodel.mutate_params_on_phase(params, "BOTH")
    sopt = SingleOptimizer(m["jconfig"])
    tx = sopt.for_phase(jmodel.trainable_predicate("BOTH"), list(params))
    state = sopt.init(params)
    loss_fn = jmodel.loss_fn("BOTH")

    @jax.jit
    def jstep(params, state, idx):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, {"map_sample_idx": idx}))(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    m["jtrain"].set_mode(JaxTrainMode.BOTH)
    jidx, jloss = [], 0.0
    for batch in m["jtrain"]:
        idx = jmodel.augment_batch(batch, "BOTH")["map_sample_idx"]
        jidx.append(idx)
        params, state, loss = jstep(params, state, jnp.asarray(idx))
        jloss += float(loss)

    trainer = get_trainer(None, "DCDCSR")(m["tconfig"], tmodel)
    tidx = []
    augment = tmodel.augment_batch

    def recorded(batch, phase):
        out = augment(batch, phase)
        tidx.append(out["map_sample_idx"])
        return out

    tmodel.augment_batch = recorded
    trainer.fit(m["ttrain"], None, verbose=False)
    assert len(tidx) == len(jidx) >= 2
    for a, b in zip(tidx, jidx):
        np.testing.assert_array_equal(a, b)
    (record,) = trainer.history
    assert "valid_seconds" not in record
    np.testing.assert_allclose(record["loss"], jloss, **EPOCH_TOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(params, name), err_msg=name,
                                   **EPOCH_TOL)


def test_second_target_rebinds_its_loop_and_trains_one_table():
    """DCDCSR runs TARGET twice: the trainer reuses the phase's device loop
    but binds the step to ``loss_fn("TARGET")`` at count 2, which trains
    only the non-affine table (items overlap: the user table)."""
    m = _pair("overlap_items")
    tmodel = m["tmodel"]
    trainer = DCDCSRTrainer(m["tconfig"], tmodel)
    tmodel.set_phase("TARGET")
    m["ttrain"].set_mode(TrainMode.TARGET)
    loop = trainer._loop_for("TARGET", m["ttrain"])
    first = loop.step_fn
    for phase in ("BOTH", "TARGET"):
        tmodel.set_phase(phase)
        tmodel.mutate_params_on_phase(phase)
    assert trainer._loop_for("TARGET", m["ttrain"]) is loop and loop.step_fn is not first
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    affine = tmodel.affine_embedding.clone()
    float(loop.run_epoch(0))
    changed = {n for n, p in tmodel.named_parameters() if not torch.equal(p, before[n])}
    assert changed == {"target_user_embedding"}, changed
    assert torch.equal(tmodel.affine_embedding, affine)


def test_snapshot_carries_the_derived_tables():
    """A state dict taken after the surgeries loads into a fresh model whose
    derived tables are still [1, D], and the other way round."""
    m = _pair("overlap_items")
    tmodel = m["tmodel"]
    for phase in SCHEDULE:
        tmodel.set_phase(phase)
        tmodel.mutate_params_on_phase(phase)
    state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    fresh = DCDCSR(m["tconfig"], m["ttrain"].dataset)
    assert fresh.benchmark_embedding.shape[0] == 1
    fresh.load_state_dict(state)
    for name in ("benchmark_embedding", "affine_embedding"):
        assert torch.equal(getattr(fresh, name), state[name])
    tmodel.load_state_dict(DCDCSR(m["tconfig"], m["ttrain"].dataset).state_dict())
    assert tmodel.affine_embedding.shape[0] == 1


def test_run_recbole_cdr_dcdcsr_on_cpu(mode_root):
    mode, root = mode_root
    extra = _user_overlap_cfg(root) if root else {}
    result = run_recbole_cdr(model="DCDCSR", config_dict={
        "state": "ERROR", "device": "cpu", "train_batch_size": 2048, **extra,
        "train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]})
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["SOURCE", "TARGET", "BOTH", "TARGET"]
    assert ["valid_seconds" in h for h in hist] == [True, True, False, True]
    assert all(math.isfinite(h["loss"]) and h["train_examples"] > 0 for h in hist)
    assert result["model"].mode == mode
    assert result["model"].affine_embedding.shape[0] > 1
    assert all(math.isfinite(v) for v in result["test_result"].values())


def test_sparse_route_falls_back_only_in_the_host_phase(capsys):
    """``phase_optimizer: sparse``: the BPR phases (the second TARGET
    included) take the row-sparse update, the host-path BOTH, which
    declares no ``sparse_spec``, the dense fallback with the JAX package's
    warning; no table gradient is left behind."""
    result = run_recbole_cdr(model="DCDCSR", config_dict={
        "state": "WARNING", "show_progress": False, "device": "cpu",
        "train_batch_size": 2048, "phase_optimizer": "sparse",
        "train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]})
    out = capsys.readouterr().out
    assert out.count("declares no sparse_spec") == 1
    assert "declares no sparse_spec for phase BOTH" in out
    assert all(math.isfinite(h["loss"]) for h in result["history"])
    assert all(math.isfinite(v) for v in result["test_result"].values())
    model = result["model"]
    assert all(p.grad is None for n, p in model.named_parameters() if "embedding" in n)
