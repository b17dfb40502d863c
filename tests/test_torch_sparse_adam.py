"""The port's SparseAdam (``phase_optimizer: sparse``) against the JAX
package's ``SparseAdam`` and against ``torch.optim.SparseAdam``, on the CPU
(where kernel B6's wrapper runs its plain version).

- ``row_update`` over several steps with unique, duplicate and all-duplicate
  ids (coalescing by summation, row-lazy moments, the per-table step count);
- ``dense_entry_update`` (torch dense Adam on the shared moments);
- the rejections of weight_decay, gradient clipping and other learners;
- one sparse BOTH epoch of CMF, and one epoch of the dense fallback of a
  phase without a ``sparse_spec``, from the same weights as the JAX
  DeviceEpochLoop with JAX's random bits injected: parameters, moments and
  step counts agree to the one-epoch tolerance of ``tests/test_torch_epoch.py``.

Tolerances: one step of ``row_update`` within rtol 2e-6 / atol 2e-7, the
bound ``tests/test_sparse_adam.py`` holds the JAX package to against
torch.optim.SparseAdam (the three compute the bias corrections and the
update in different orders and precisions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.trainer.trainer import SparseAdam as JaxSparseAdam
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.ops import launch_counts, reset_launch_counts
from recbole_cdr_tpu_torch.trainer.trainer import SparseAdam, make_sparse_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode

from test_torch_epoch import JaxRandomSource

STEP_TOL = dict(rtol=2e-6, atol=2e-7)
EPOCH_TOL = dict(rtol=5e-3, atol=1e-5)


class _Cfg(dict):
    def __getitem__(self, k):
        return self.get(k)


def _table(N, D):
    m = nn.Module()
    m.table = nn.Parameter(torch.zeros(N, D))
    return m


@pytest.mark.parametrize("ids_kind", ["duplicates", "all_duplicate", "unique"])
def test_row_update_matches_jax_and_torch(ids_kind):
    N, D, R, steps = 50, 8, 24, 4
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(N, D)).astype(np.float32)
    cfg = _Cfg(learning_rate=0.01, learner="adam")
    jopt, opt = JaxSparseAdam(cfg), SparseAdam(cfg, _table(N, D))
    jp, jmu, jnu = jnp.asarray(p0), jnp.zeros((N, D)), jnp.zeros((N, D))
    p, mu, nu = torch.tensor(p0), torch.zeros(N, D), torch.zeros(N, D)
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.SparseAdam([tp], lr=0.01)
    reset_launch_counts()
    for c in range(1, steps + 1):
        ids = {"duplicates": rng.integers(0, N, R), "all_duplicate": np.full(R, 7),
               "unique": rng.permutation(N)[:R]}[ids_kind].astype(np.int32)
        g = rng.normal(size=(R, D)).astype(np.float32)
        jp, jmu, jnu = jopt.row_update(jp, jmu, jnu, jnp.asarray(g), jnp.asarray(ids),
                                       jnp.int32(c))
        opt.row_update(p, mu, nu, torch.from_numpy(g), torch.from_numpy(ids), c)
        tp.grad = torch.sparse_coo_tensor(torch.from_numpy(ids.astype(np.int64))[None],
                                          torch.from_numpy(g), size=(N, D))
        topt.step()
        for name, got, want in (("p", p, jp), ("mu", mu, jmu), ("nu", nu, jnu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL,
                                       err_msg=f"{name} step {c}")
        st = topt.state[tp]
        for got, want in ((p, tp.detach()), (mu, st["exp_avg"]), (nu, st["exp_avg_sq"])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **STEP_TOL, err_msg=f"step {c}")
    untouched = np.setdiff1d(np.arange(N), ids) if ids_kind == "all_duplicate" else []
    assert (p.numpy()[untouched] == p0[untouched]).all()  # lazy: never-touched rows stay
    assert launch_counts()["sparse_adam"] == 0  # the plain version on the CPU


def test_dense_entry_update_matches_jax():
    rng = np.random.default_rng(1)
    cfg = _Cfg(learning_rate=0.003, learner="sparse_adam")
    jopt, opt = JaxSparseAdam(cfg), SparseAdam(cfg, _table(3, 5))
    jmu = jnu = jnp.zeros((7, 5))
    mu = nu = torch.zeros(7, 5)
    for c in range(1, 5):
        g = rng.normal(size=(7, 5)).astype(np.float32)
        jupd, jmu, jnu = jopt.dense_entry_update(jnp.asarray(g), jmu, jnu, jnp.int32(c))
        upd, mu, nu = opt.dense_entry_update(torch.from_numpy(g), mu, nu, c)
        for got, want in ((upd, jupd), (mu, jmu), (nu, jnu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL, err_msg=f"step {c}")


@pytest.mark.parametrize("extra,match", [
    ({"weight_decay": 0.1}, "weight_decay"),
    ({"clip_grad_norm": {"max_norm": 1.0}}, "clip_grad_norm"),
    ({"learner": "sgd"}, "adam/sparse_adam"),
])
def test_sparse_rejects_what_sparse_adam_cannot_do(extra, match):
    cfg = _Cfg({"learning_rate": 0.01, "learner": "adam", **extra})
    with pytest.raises(ValueError, match=match):
        JaxSparseAdam(cfg)
    with pytest.raises(ValueError, match=match):
        SparseAdam(cfg, _table(2, 2))
    with pytest.raises(ValueError, match=match):
        run_recbole_cdr(model="CMF", config_dict={
            "state": "ERROR", "device": "cpu", "train_epochs": ["BOTH:1"],
            "phase_optimizer": "sparse", **extra})


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse_spec", "dense_fallback"])
def test_one_epoch_sparse_parameter_match(sparse):
    """``dense_fallback``: a phase without a spec takes the dense update on
    the shared state (JAX: the inherited SingleOptimizer transform)."""
    cfg = {"state": "ERROR", "train_batch_size": 1024, "device": "cpu",
           "train_epochs": ["BOTH:1"], "phase_optimizer": "sparse"}
    base_rng = jax.random.PRNGKey(1)

    jconfig = JaxConfig(model="CMF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxCMF(jconfig, jdataset)
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    jopt = JaxSparseAdam(jconfig)
    spec = jmodel.sparse_spec("BOTH") if sparse else None
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), jopt.for_phase(lambda k: True, list(params0)),
        jtrain, jconfig["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng,
        donate=False, sparse=(spec, jopt, {k: True for k in params0}) if sparse else None,
    )
    jparams, jstate, jloss = jl.run_epoch(params0, jopt.init(params0), 0)

    tconfig = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = CMF(tconfig, tdataset)
    model.load_state_dict(params_from_jax(jax.device_get(params0)))
    opt = SparseAdam(tconfig, model)
    step = make_sparse_train_step(model, opt, "BOTH", model.sparse_spec("BOTH") if sparse else {},
                                  lambda n: True)
    tl = torch_loop.DeviceEpochLoop(
        TrainMode.BOTH, step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, JaxRandomSource(base_rng), "cpu",
    )
    assert tl.steps_per_epoch >= 3
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), **EPOCH_TOL)
    for name in ("user_embedding", "item_embedding"):
        assert getattr(model, name).grad is None  # no [N, D] gradient is kept
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(jparams[name]), **EPOCH_TOL, err_msg=name)
        for moment in ("mu", "nu"):
            np.testing.assert_allclose(opt.state[moment][name].numpy(),
                                       np.asarray(jstate[moment][name]), rtol=5e-3, atol=1e-7,
                                       err_msg=f"{moment} {name}")
        assert opt.state["count"][name] == int(jstate["count"][name]) == tl.steps_per_epoch
