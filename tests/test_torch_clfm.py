"""CLFM in the PyTorch port against the JAX model, on the CPU, on the bundled
ml-1m -> ml-100k pair (which overlaps on items; CLFM's arithmetic does not
depend on the overlap). The same weights (``params_from_jax``) and, for the
epoch, the same random bits go to both. Tolerances, each with its case:

- loss and every parameter's gradient: ``LOSS_TOL`` / ``GRAD_TOL``
  (``tests/test_oracle_equivalence.py:31-32``), at ``share_embedding_size``
  0, 32 and 64, so that each optional map is absent once;
- ``predict``, ``full_sort`` and ``full_sort_factors`` against JAX's
  ``predict_fn``, ``full_sort_fn`` and ``full_sort_factors``: rtol 2e-4,
  atol 2e-5 (``tests/test_oracle_equivalence.py::_check_full_sort``);
- one BOTH epoch with JAX's shuffle and negative bits: rtol 5e-3 / atol
  1e-5, the CMF epoch test's tolerance;
- the bf16 loss and gradients under ``compute_dtype: bfloat16``: the
  tolerances and checks of ``tests/test_torch_precision.py``.

The one-epoch helper here serves the DeepAPF and CoNet tests too.
"""

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
from recbole_cdr_tpu.models.clfm import CLFM as JaxCLFM
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.clfm import CLFM
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import get_model, init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from test_torch_dcdcsr import assert_loss_and_grads_match, build_pair, jax_leaf, phase_batch
from test_torch_epoch import JaxRandomSource
from test_torch_model import _tbatch
from test_torch_precision import _check_bf16

SCORE_TOL = dict(rtol=2e-4, atol=2e-5)
EPOCH_TOL = dict(rtol=5e-3, atol=1e-5)
#: the optional maps of each ``share_embedding_size`` (item width 64)
MAPS = {0: {"source_only_linear", "target_only_linear"},
        32: {"shared_linear", "source_only_linear", "target_only_linear"},
        64: {"shared_linear"}}


def user_overlap_cfg(root):
    """The user-overlap pair of ``tests/test_user_overlap.py`` at ``root``."""
    return {"source_dataset": "uo-src", "target_dataset": "uo-tgt",
            "source_data_path": root, "target_data_path": root,
            "source_user_inter_num_interval": "[2,inf)",
            "source_item_inter_num_interval": "[2,inf)",
            "target_user_inter_num_interval": "[2,inf)",
            "target_item_inter_num_interval": "[2,inf)",
            "source_val_interval": None, "target_val_interval": None,
            "eval_batch_size": 2048}


def one_epoch_match(name, jax_cls, torch_cls, extra=None):
    """One BOTH epoch of the port's loop (torch Adam, the plain kernels)
    against JAX's DeviceEpochLoop from the same weights, with JAX's shuffle
    and negative bits through the random source: the loss and every
    parameter within ``EPOCH_TOL``. Returns the trained port model and the
    initial parameters."""
    cfg = {"state": "ERROR", "train_batch_size": 1024, "device": "cpu",
           "train_epochs": ["BOTH:1"], **(extra or {})}
    base_rng = jax.random.PRNGKey(1)
    jconfig = JaxConfig(model=name, config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = jax_cls(jconfig, jdataset)
    params0 = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    sopt = SingleOptimizer(jconfig)
    tx = sopt.for_phase(jmodel.trainable_predicate("BOTH"), list(params0))
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), tx, jtrain, jconfig["MODEL_INPUT_TYPE"], 1,
        jmodel.total_num_users, base_rng, donate=False)
    jparams, _, jloss = jl.run_epoch(params0, sopt.init(params0), 0)

    tconfig = CDRConfig(model=name, config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = torch_cls(tconfig, tdataset)
    model.load_state_dict(params_from_jax(params0))
    step = make_train_step(model, build_optimizer(tconfig, model.parameters()),
                           model.loss_fn("BOTH"), model.trainable_predicate("BOTH"))
    tl = torch_loop.DeviceEpochLoop(
        TrainMode.BOTH, step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1, model.total_num_users,
        JaxRandomSource(base_rng), "cpu")
    assert (tl.steps_per_epoch, tl.seg_steps) == (jl.steps_per_epoch, jl.seg_steps)
    assert tl.steps_per_epoch > 1
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), **EPOCH_TOL)
    jparams = jax.device_get(jparams)
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jparams, pname), err_msg=pname,
                                   **EPOCH_TOL)
    return model, params0


def check_predict(m, n=64, seed=0):
    """The port's ``predict`` against JAX's ``predict_fn`` on random target
    pairs."""
    rng = np.random.default_rng(seed)
    tmodel = m["tmodel"]
    users = rng.integers(0, tmodel.total_num_users, n)
    items = rng.integers(0, tmodel.total_num_items, n)
    jbatch = {tmodel.TARGET_USER_ID: jnp.asarray(users), tmodel.TARGET_ITEM_ID: jnp.asarray(items)}
    want = np.asarray(m["jmodel"].predict_fn()(m["params"], jbatch))
    with torch.no_grad():
        got = tmodel.predict({tmodel.TARGET_USER_ID: torch.from_numpy(users.astype(np.int32)),
                              tmodel.TARGET_ITEM_ID: torch.from_numpy(items.astype(np.int32))})
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)


@pytest.fixture(scope="module", params=sorted(MAPS))
def pair(request):
    return build_pair("CLFM", JaxCLFM, CLFM, {"share_embedding_size": request.param})


def test_get_model_resolves_clfm():
    assert get_model("CLFM") is CLFM


def test_maps_follow_the_share_width(pair):
    """Each map exists only where its width is positive, as JAX's pytree."""
    names = {n for n, _ in pair["tmodel"].named_parameters()}
    tables = {f"{d}_{s}_embedding" for d in ("source", "target") for s in ("user", "item")}
    assert names == tables | MAPS[pair["tmodel"].share_embedding_size]
    assert names == set(params_from_jax(pair["params"]))


def test_clfm_loss_and_grads_match_jax(pair):
    batch = phase_batch(pair["jtrain"], "BOTH")
    assert_loss_and_grads_match(pair["jmodel"], pair["params"], pair["tmodel"], "BOTH", batch)


def test_predict_and_full_sort_match_jax(pair):
    """``predict``; ``full_sort`` over the target prefix and the two factors
    of ``full_sort_factors`` against JAX's."""
    check_predict(pair)
    jmodel, tmodel, params = pair["jmodel"], pair["tmodel"], pair["params"]
    users = np.arange(1, 41)
    want = np.asarray(jmodel.full_sort_fn("TARGET")(params, jnp.asarray(users)))
    with torch.no_grad():
        got = tmodel.full_sort_fn("TARGET")(torch.from_numpy(users))
        fac_u, fac_i = tmodel.full_sort_factors("TARGET")(torch.from_numpy(users))
    assert got.shape == want.shape == (len(users), tmodel.target_num_items)
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)
    want_u, want_i = jmodel.full_sort_factors("TARGET")(params, jnp.asarray(users))
    np.testing.assert_allclose(fac_u.numpy(), np.asarray(want_u), **SCORE_TOL)
    np.testing.assert_array_equal(fac_i.detach().numpy(), np.asarray(want_i))


def test_one_epoch_clfm_parameter_match():
    one_epoch_match("CLFM", JaxCLFM, CLFM)


def test_bf16_loss_and_grads_match_jax():
    """Under ``compute_dtype: bfloat16``, against JAX's bf16 loss and
    gradients, with ``tests/test_torch_precision.py``'s checks (which also
    require each matrix's gradient to carry bf16 rounding)."""
    from recbole_cdr_tpu.utils.precision import with_compute_dtype as jax_with_compute_dtype
    from recbole_cdr_tpu_torch.utils.precision import with_compute_dtype

    m = build_pair("CLFM", JaxCLFM, CLFM)
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    batch = phase_batch(m["jtrain"], "BOTH")
    jparams = jax.tree_util.tree_map(jnp.asarray, m["params"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_grads(dtype):
        loss_fn = jax_with_compute_dtype(jmodel.loss_fn("BOTH"), dtype)
        return jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jbatch, None)))(jparams)

    jloss, jgrads = jax_grads(jnp.bfloat16)
    _, grads32 = jax_grads(jnp.float32)
    tmodel.zero_grad(set_to_none=True)
    tloss = with_compute_dtype(tmodel.loss_fn("BOTH"), torch.bfloat16, tmodel)(_tbatch(batch))
    tloss.backward()
    _check_bf16(tloss, tmodel, jloss, jgrads, grads32)


@pytest.mark.parametrize("extra", [{}, {"compute_dtype": "bfloat16",
                                        "streaming_topk_threshold": 1}])
def test_run_recbole_cdr_clfm_on_cpu(extra):
    """The entry point: BOTH:1 with validation, the dense evaluator (no
    kernel launch on the CPU), and in bf16 through the streaming evaluator
    (B13's plain version)."""
    ops.reset_launch_counts()
    result = run_recbole_cdr(model="CLFM", config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu",
        "train_batch_size": 1024, "train_epochs": ["BOTH:1"], **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    assert all(math.isfinite(h["loss"]) and "valid_seconds" in h for h in result["history"])
    assert not any(ops.launch_counts().values())
