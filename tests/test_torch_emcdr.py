"""EMCDR in the PyTorch port against the JAX model, on the CPU (where K1's
and K3's wrappers run their plain versions), on the bundled pair
(overlapped items) and ``tests/test_user_overlap.py``'s pair (overlapped
users), in its MF (``loss_type: CE``, pointwise) and BPR (pairwise) forms.

Tolerances, each with its case:

- the OVERLAP stream: bit-equal to the JAX DeviceEpochLoop's batches under
  JAX's bits;
- one epoch of each phase in turn, SOURCE, TARGET, OVERLAP, with one
  optimizer state across them: rtol 5e-3 / atol 1e-5, the CMF epoch test's
  tolerance;
- the mapped scores (``full_sort`` and ``predict`` after OVERLAP, both
  mapping functions): rtol 1e-5 / atol 1e-6 (one MLP and one product in
  float32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.models.emcdr import EMCDR as JaxEMCDR
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.models.emcdr import EMCDR
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils.enums import InputType, TrainMode
from test_torch_dcdcsr import EPOCH_TOL, build_pair, jax_leaf
from test_torch_epoch import JaxRandomSource, assert_streams_equal, recording
from test_torch_natr import _user_overlap_cfg
from test_user_overlap import pair_root  # noqa: F401  (fixture)

FORMS = {"CE": {}, "BPR": {"loss_type": "BPR", "latent_factor_model": "BPR"}}
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(mode, root=None, extra=None):
    extra = {**(_user_overlap_cfg(root) if mode == "overlap_users" else {}),
             "overlap_batch_size": 16, **(extra or {})}
    m = build_pair("EMCDR", JaxEMCDR, EMCDR, extra)
    assert m["jmodel"].mode == m["tmodel"].mode == mode
    return m


@pytest.fixture(params=["overlap_items", "overlap_users"])
def mode_root(request):
    root = request.getfixturevalue("pair_root") if request.param == "overlap_users" else None
    return request.param, root


def test_config_derives_the_input_type_from_loss_type():
    assert _pair("overlap_items")["tconfig"]["MODEL_INPUT_TYPE"] == InputType.POINTWISE
    m = _pair("overlap_items", extra=FORMS["BPR"])
    assert m["tconfig"]["MODEL_INPUT_TYPE"] == InputType.PAIRWISE
    assert m["tmodel"].is_pairwise


def test_overlap_stream_matches_jax(mode_root):
    """Every OVERLAP step's ids and weights, the last step padded, bit-equal
    to the JAX loop's (swap-or-not over n_over keyed from the third split
    of the epoch's shuffle key)."""
    m = _pair(*mode_root)
    jmodel, params = m["jmodel"], m["params"]
    base_rng = jax.random.PRNGKey(9)
    sopt = SingleOptimizer(m["jconfig"])
    seen = []
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.OVERLAP, recording(jmodel.loss_fn("OVERLAP"), seen),
        sopt.for_phase(lambda k: True, list(params)), m["jtrain"],
        m["jconfig"]["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng, donate=False)
    for epoch in (0, 1):
        jax.block_until_ready(jl._epoch_fn(params, sopt.init(params),
                                           jax.random.fold_in(base_rng, epoch), jl._buffers))
    jax.effects_barrier()
    got = []

    def step(batch, rng=None):
        got.append({k: v.numpy().copy() for k, v in batch.items()})
        return torch.zeros(())

    tl = torch_loop.DeviceEpochLoop(TrainMode.OVERLAP, step, m["ttrain"],
                                    m["tconfig"]["MODEL_INPUT_TYPE"], 1,
                                    m["tmodel"].total_num_users, JaxRandomSource(base_rng),
                                    "cpu")
    tl.run_epoch(0)
    tl.run_epoch(1)
    assert tl.steps_per_epoch == jl.steps_per_epoch and tl.examples_per_step == 16
    assert_streams_equal(seen, got)
    n_over = len(m["ttrain"].overlap_batcher.overlap)
    ids = np.concatenate([b["overlap"][b["overlap_sample_weight"] > 0]
                          for b in got[:tl.steps_per_epoch]])
    assert sorted(ids) == list(range(n_over)) and n_over % 16  # a padded last step


@pytest.mark.parametrize("form", sorted(FORMS))
def test_one_epoch_each_phase_matches_jax(form):
    """SOURCE, TARGET and OVERLAP in turn, one device epoch each with JAX's
    bits, one optimizer across them (K1's plain version for the MF dots)."""
    m = _pair("overlap_items", extra=FORMS[form])
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    sopt = SingleOptimizer(m["jconfig"])
    state = sopt.init(params)
    opt = build_optimizer(m["tconfig"], tmodel.parameters())
    for i, phase in enumerate(("SOURCE", "TARGET", "OVERLAP")):
        jmodel.set_phase(phase)
        tmodel.set_phase(phase)
        base_rng = jax.random.PRNGKey(20 + i)
        jl = jax_loop.DeviceEpochLoop(
            JaxTrainMode[phase], jmodel.loss_fn(phase),
            sopt.for_phase(jmodel.trainable_predicate(phase), list(params)), m["jtrain"],
            m["jconfig"]["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng,
            donate=False)
        params, state, jloss = jl.run_epoch(params, state, 0)
        step = make_train_step(tmodel, opt, tmodel.loss_fn(phase),
                               tmodel.trainable_predicate(phase))
        tl = torch_loop.DeviceEpochLoop(
            TrainMode[phase], step, m["ttrain"], m["tconfig"]["MODEL_INPUT_TYPE"], 1,
            tmodel.total_num_users, JaxRandomSource(base_rng), "cpu")
        assert tl.steps_per_epoch == jl.steps_per_epoch >= 2
        np.testing.assert_allclose(float(tl.run_epoch(0)), float(jloss), err_msg=phase,
                                   **EPOCH_TOL)
        for name, p in tmodel.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), jax_leaf(params, name),
                                       err_msg=f"{phase} {name}", **EPOCH_TOL)


@pytest.mark.parametrize("mapping", ["linear", "non_linear"])
def test_mapped_scores_match_jax(mode_root, mapping):
    """After OVERLAP the overlapped entities score through their mapped
    source embedding: ``full_sort`` (and its factors) and ``predict``
    against JAX's ``full_sort_fn`` / ``predict_fn``, every phase's form."""
    m = _pair(*mode_root, extra={"mapping_function": mapping})
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    n_users = jmodel.target_num_users
    users = np.arange(1, min(n_users, 40))
    items = np.random.default_rng(0).integers(1, jmodel.target_num_items, len(users))
    for phase in ("SOURCE", "TARGET", "OVERLAP"):
        jmodel.set_phase(phase)
        tmodel.set_phase(phase)
        got = tmodel.full_sort(torch.as_tensor(users), phase).detach().numpy()
        want = np.asarray(jmodel.full_sort_fn(phase)(params, jnp.asarray(users)))
        np.testing.assert_allclose(got, want, err_msg=phase, **SCORE_TOL)
        user_e, item_e = tmodel.full_sort_factors(phase)(torch.as_tensor(users))
        np.testing.assert_allclose((user_e @ item_e.T).detach().numpy(), want, **SCORE_TOL)
        if phase == "SOURCE":
            continue
        batch = {jmodel.TARGET_USER_ID: users, jmodel.TARGET_ITEM_ID: items}
        got = tmodel.predict({k: torch.as_tensor(v) for k, v in batch.items()})
        want = jmodel.predict_fn()(params, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=phase,
                                   **SCORE_TOL)


@pytest.mark.parametrize("extra", [
    {},
    FORMS["BPR"],
    {"mapping_function": "linear", "phase_optimizer": "sparse", "streaming_topk_threshold": 1},
], ids=["CE", "BPR", "sparse_streaming"])
def test_run_recbole_cdr_emcdr_on_cpu(extra):
    result = run_recbole_cdr(model="EMCDR", config_dict={
        "state": "ERROR", "device": "cpu", "train_batch_size": 2048,
        "train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:2"], **extra})
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["SOURCE", "TARGET", "OVERLAP", "OVERLAP"]
    assert all(math.isfinite(h["loss"]) and h["train_examples"] > 0 for h in hist)
    assert all(math.isfinite(v) for v in result["test_result"].values())


def test_run_recbole_cdr_emcdr_user_overlap(pair_root):  # noqa: F811
    result = run_recbole_cdr(model="EMCDR", config_dict={
        "state": "ERROR", "device": "cpu", "train_batch_size": 256,
        **_user_overlap_cfg(pair_root), "train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"]})
    assert result["model"].mode == "overlap_users"
    assert all(math.isfinite(v) for v in result["test_result"].values())
