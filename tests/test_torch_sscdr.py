"""SSCDR in the PyTorch port against the JAX model, on the CPU, on the
bundled pair (overlapped items) and ``tests/test_user_overlap.py``'s pair
(overlapped users).

Tolerances, each with its case:

- ``augment_batch``'s neighbours: equal to JAX's for the same seed and ids;
- the triplet and mapping losses and every parameter's gradient:
  ``LOSS_TOL`` / ``GRAD_TOL`` (``tests/test_oracle_equivalence.py:31-32``);
- the distance full-sort (a matmul expansion) and ``predict``: atol 1e-5,
  rtol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.models.sscdr import SSCDR as JaxSSCDR
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.models.sscdr import SSCDR
from test_torch_dcdcsr import assert_loss_and_grads_match, build_pair, phase_batch
from test_torch_natr import _user_overlap_cfg
from test_user_overlap import pair_root  # noqa: F401  (fixture)

DIST_TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(mode, root=None):
    extra = {**(_user_overlap_cfg(root) if mode == "overlap_users" else {}),
             "overlap_batch_size": 32}
    m = build_pair("SSCDR", JaxSSCDR, SSCDR, extra)
    assert m["jmodel"].mode == m["tmodel"].mode == mode
    return m


@pytest.fixture(params=["overlap_items", "overlap_users"])
def pair(request):
    root = request.getfixturevalue("pair_root") if request.param == "overlap_users" else None
    return _pair(request.param, root)


def test_augment_batch_matches_jax(pair):
    """The same overlap batches through both samplers, seeded alike: equal
    positive and negative neighbours, batch after batch (PAD's empty
    interacted set included)."""
    jmodel, tmodel = pair["jmodel"], pair["tmodel"]
    pair["jtrain"].set_mode(JaxTrainMode.OVERLAP)
    batches = [b for _ in range(3) for b in pair["jtrain"]]
    assert any((b["overlap"] == 0).any() for b in batches)
    for b in batches:
        want = jmodel.augment_batch(b, "OVERLAP")
        got = tmodel.augment_batch(b, "OVERLAP")
        np.testing.assert_array_equal(got["overlap_pos"], want["overlap_pos"])
        np.testing.assert_array_equal(got["overlap_neg"], want["overlap_neg"])
    assert tmodel.augment_batch(b, "SOURCE") is b


def test_losses_and_grads_match_jax(pair):
    """Each phase's loss and gradients on one batch: the triplet phases on
    the pairwise loader, OVERLAP with JAX's neighbours."""
    jmodel, params, tmodel = pair["jmodel"], pair["params"], pair["tmodel"]
    for phase in ("SOURCE", "TARGET", "OVERLAP"):
        jmodel.set_phase(phase)
        tmodel.set_phase(phase)
        batch = jmodel.augment_batch(phase_batch(pair["jtrain"], phase), phase)
        loss = assert_loss_and_grads_match(jmodel, params, tmodel, phase, batch)
        assert loss > 0, phase


def test_distance_full_sort_and_predict_match_jax(pair):
    jmodel, params, tmodel = pair["jmodel"], pair["params"], pair["tmodel"]
    users = np.arange(1, min(jmodel.target_num_users, 40))
    items = np.random.default_rng(1).integers(1, jmodel.target_num_items, len(users))
    assert tmodel.full_sort_factors("OVERLAP") is None  # dense only
    for phase in ("SOURCE", "TARGET", "OVERLAP"):
        jmodel.set_phase(phase)
        tmodel.set_phase(phase)
        got = tmodel.full_sort(torch.as_tensor(users), phase).detach().numpy()
        want = np.asarray(jmodel.full_sort_fn(phase)(params, jnp.asarray(users)))
        np.testing.assert_allclose(got, want, err_msg=phase, **DIST_TOL)
        if phase == "SOURCE":
            continue
        batch = {jmodel.TARGET_USER_ID: users, jmodel.TARGET_ITEM_ID: items}
        got = tmodel.predict({k: torch.as_tensor(v) for k, v in batch.items()})
        want = jmodel.predict_fn()(params, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=phase,
                                   **DIST_TOL)


@pytest.mark.parametrize("mode", ["overlap_items", "overlap_users"])
def test_run_recbole_cdr_sscdr_on_cpu(mode, request):
    """All three phases end to end; OVERLAP on the host batch path (its
    batches pass through ``augment_batch``)."""
    extra = {}
    if mode == "overlap_users":
        extra = _user_overlap_cfg(request.getfixturevalue("pair_root"))
    result = run_recbole_cdr(model="SSCDR", config_dict={
        "state": "ERROR", "device": "cpu", "train_batch_size": 1024, **extra,
        "train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:2"]})
    hist = result["history"]
    assert [h["phase"] for h in hist] == ["SOURCE", "TARGET", "OVERLAP", "OVERLAP"]
    assert all(math.isfinite(h["loss"]) and h["train_examples"] > 0 for h in hist)
    assert result["model"].mode == mode
    assert all(math.isfinite(v) for v in result["test_result"].values())


def test_one_epoch_host_overlap_parameter_match():
    """SSCDR's OVERLAP on the port's host batch path (``CrossDomainTrainer
    .fit``: the loader's batches, ``augment_batch``, one Adam step each)
    against the same batches and neighbours stepped through the JAX loss
    with the JAX package's torch-exact Adam: rtol 5e-3 / atol 1e-5, the
    epoch tests' tolerance."""
    import optax

    from recbole_cdr_tpu.trainer.trainer import SingleOptimizer

    from recbole_cdr_tpu_torch.utils import get_trainer
    from test_torch_dcdcsr import EPOCH_TOL, jax_leaf

    m = build_pair("SSCDR", JaxSSCDR, SSCDR, {"overlap_batch_size": 16,
                                              "train_epochs": ["OVERLAP:1"]})
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    jmodel.set_phase("OVERLAP")
    sopt = SingleOptimizer(m["jconfig"])
    tx = sopt.for_phase(jmodel.trainable_predicate("OVERLAP"), list(params))
    state = sopt.init(params)
    loss_fn = jmodel.loss_fn("OVERLAP")

    def jstep(params, state, batch):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(p, batch))(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    jstep = jax.jit(jstep)
    m["jtrain"].set_mode(JaxTrainMode.OVERLAP)
    np.random.seed(5)  # the loaders shuffle the overlap ids with numpy's global state
    jloss, n = 0.0, 0
    for batch in m["jtrain"]:
        batch = jmodel.augment_batch(batch, "OVERLAP")
        params, state, loss = jstep(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        jloss, n = jloss + float(loss), n + 1

    trainer = get_trainer(None, "SSCDR")(m["tconfig"], tmodel)
    np.random.seed(5)
    trainer.fit(m["ttrain"], None, verbose=False)
    (record,) = trainer.history
    assert n >= 3 and record["train_examples"] == 16 * n
    np.testing.assert_allclose(record["loss"], jloss, **EPOCH_TOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(params, name), err_msg=name,
                                   **EPOCH_TOL)
