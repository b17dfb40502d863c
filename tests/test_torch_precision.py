"""Mixed precision (``compute_dtype: bfloat16``) in the port against the JAX
package, on the CPU (K1's plain version on bf16 tables).

- A bf16 loss and its float32 master gradients, from the same weights and
  batch, against JAX's ``with_compute_dtype(loss_fn, bfloat16)``, for CMF,
  EMCDR and DTCDR's NeuMF. Both sides round to bf16 (unit roundoff
  u = 2^-8) at other places: JAX rounds every product of a dot and sums in
  bf16, the port's K1 sums exact products in float32 and rounds once, and
  the MLPs' products round per element in both. A value that passes through
  a few such roundings differs by a few u of its magnitude, so the loss is
  held within ``LOSS_TOL`` (4u relative), and every gradient of a table or
  a weight matrix within ``GRAD_TOL`` in norm (``|g - g_jax| <= 16u
  |g_jax|``, room for the roundings of a chain of a few bf16 operations).
  A bias's gradient is a sum over the batch's pairs with much cancellation,
  which JAX rounds in bf16 and torch accumulates in float32; there the two
  differ by up to the bf16 sum's own error, so every gradient is also held
  to be no farther from the float32 gradient than JAX's bf16 one is, plus
  ``GRAD_TOL`` (``|g - g_f32| <= |g_jax - g_f32| + 16u |g_f32|``). Those
  two bounds also hold for a port that computes in float32, so every table
  and weight-matrix gradient must also lie at least half as far from the
  float32 gradient as JAX's bf16 one does (``|g - g_f32| >= |g_jax - g_f32|
  / 2``): on the bundled pair that ratio is 0.72 to 1.0 in bf16 and below
  3e-4 with the port in float32, and
  ``test_float32_compute_fails_the_bf16_checks`` holds the latter.
- The master parameters and the optimizer state stay float32; bf16 quality
  within 0.04 of float32 for CMF over 3 epochs; bf16 on the host batch path
  (the analogues of ``tests/test_precision.py``).
- BiTGCF, NATR and DTCDR's DMF raise under bf16, naming their ROADMAP item.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.models.dtcdr import DTCDR as JaxDTCDR
from recbole_cdr_tpu.models.emcdr import EMCDR as JaxEMCDR
from recbole_cdr_tpu.utils.precision import with_compute_dtype as jax_with_compute_dtype

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
from recbole_cdr_tpu_torch.models.emcdr import EMCDR
from recbole_cdr_tpu_torch.utils import get_model
from recbole_cdr_tpu_torch.utils.precision import (
    cast_floats,
    resolve_compute_dtype,
    with_compute_dtype,
)
from test_torch_dcdcsr import build_pair, jax_leaf, phase_batch
from test_torch_model import _tbatch

U_BF16 = 2.0 ** -8
LOSS_TOL = 4 * U_BF16
GRAD_TOL = 16 * U_BF16

_QUICK = {"state": "ERROR", "show_progress": False, "device": "cpu",
          "train_batch_size": 1024}

#: (name, JAX class, port class, extra config, phase)
_MODELS = {
    "CMF": (JaxCMF, CMF, {}, "BOTH"),
    "EMCDR": (JaxEMCDR, EMCDR, {}, "SOURCE"),
    "EMCDR-BPR": (JaxEMCDR, EMCDR, {"loss_type": "BPR", "latent_factor_model": "BPR"},
                  "TARGET"),
    "DTCDR-NeuMF": (JaxDTCDR, DTCDR, {"base_model": "NeuMF", "dropout_prob": 0.0}, "BOTH"),
}


def test_cast_floats_types():
    tensors = {"table": torch.ones(4, 2), "ids": torch.arange(3, dtype=torch.int32),
               "mask": torch.ones(3, dtype=torch.bool)}
    out = cast_floats(tensors, torch.bfloat16)
    assert out["table"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32 and out["mask"].dtype == torch.bool


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32), ("fp32", torch.float32),
                                        ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                                        ("float16", torch.float16), ("fp16", torch.float16)])
def test_resolve_compute_dtype_names(name, dtype):
    assert resolve_compute_dtype({"compute_dtype": name}) == dtype


def test_resolve_compute_dtype_rejects_garbage():
    with pytest.raises(ValueError):
        resolve_compute_dtype({"compute_dtype": "int8"})


def test_wrap_keeps_routing_flags_and_float32_identity():
    model = torch.nn.Linear(2, 2)
    fn = lambda x: model(x)  # noqa: E731
    fn._pair_cost = True
    assert with_compute_dtype(fn, torch.float32, model) is fn
    wrapped = with_compute_dtype(fn, torch.bfloat16, model)
    assert wrapped._pair_cost
    out = wrapped(torch.ones(3, 2, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert model.weight.dtype == model.weight.grad.dtype == torch.float32


def _loss_and_grads(name, dtype):
    """The port's loss and parameters after a backward pass under
    ``dtype``, with JAX's bf16 loss and gradients and its float32
    gradients, from the same weights and batch."""
    jax_cls, torch_cls, extra, phase = _MODELS[name]
    m = build_pair(name.split("-")[0], jax_cls, torch_cls, extra)
    jmodel, tmodel, params = m["jmodel"], m["tmodel"], m["params"]
    jmodel.set_phase(phase)
    tmodel.set_phase(phase)
    batch = phase_batch(m["jtrain"], phase)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_grads(dtype):
        loss_fn = jax_with_compute_dtype(jmodel.loss_fn(phase), dtype)
        return jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jbatch, None)))(jparams)

    jloss, jgrads = jax_grads(jnp.bfloat16)
    _, grads32 = jax_grads(jnp.float32)
    tmodel.zero_grad(set_to_none=True)
    tloss = with_compute_dtype(tmodel.loss_fn(phase), dtype, tmodel)(_tbatch(batch))
    tloss.backward()
    return tloss, tmodel, jloss, jgrads, grads32


def _check_bf16(tloss, tmodel, jloss, jgrads, grads32):
    assert tloss.dtype == torch.float32
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    checked = 0
    for pname, p in tmodel.named_parameters():
        want = jax_leaf(jgrads, pname).astype(np.float32)
        exact = jax_leaf(grads32, pname)
        assert p.dtype == torch.float32
        if not np.any(want):
            assert p.grad is None or not torch.any(p.grad), pname
            continue
        got = p.grad.numpy()
        assert p.grad.dtype == torch.float32, pname
        norm = np.linalg.norm
        assert norm(got - exact) <= norm(want - exact) + GRAD_TOL * norm(exact), pname
        if p.dim() >= 2:
            assert norm(got - exact) >= norm(want - exact) / 2, \
                f"{pname}: no bf16 rounding in the gradient"
            assert norm(got - want) <= GRAD_TOL * norm(want), (pname, norm(got - want))
            checked += 1
    assert checked >= 2


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_bf16_loss_and_grads_match_jax(name):
    _check_bf16(*_loss_and_grads(name, torch.bfloat16))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_float32_compute_fails_the_bf16_checks(name):
    """The negative control: a port that ignored ``compute_dtype`` and
    computed in float32 would not pass :func:`_check_bf16`."""
    with pytest.raises(AssertionError, match="no bf16 rounding"):
        _check_bf16(*_loss_and_grads(name, torch.float32))


def _trained(extra):
    result = run_recbole_cdr(model="CMF", config_dict={**_QUICK, **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    return result


def test_master_params_and_optimizer_state_stay_f32():
    result = _trained({"train_epochs": ["BOTH:1"], "compute_dtype": "bfloat16"})
    for name, p in result["model"].named_parameters():
        assert p.dtype == torch.float32, name


@pytest.mark.parametrize("extra", [{}, {"phase_optimizer": "sparse",
                                        "streaming_topk_threshold": 1}])
def test_optimizer_state_stays_f32(extra):
    from recbole_cdr_tpu_torch.data.utils import data_preparation
    from recbole_cdr_tpu_torch.trainer.trainer import CrossDomainTrainer

    config = CDRConfig(model="CMF", config_dict={**_QUICK, "train_epochs": ["BOTH:1"],
                                                 "compute_dtype": "bfloat16", **extra},
                       _cli_args=[])
    dataset = CrossDomainDataset(config)
    train_data, valid_data, _ = data_preparation(config, dataset)
    trainer = CrossDomainTrainer(config, CMF(config, dataset))
    trainer.fit(train_data, valid_data, verbose=False, saved=False)
    opt = trainer.optimizer
    states = (list(opt.state["mu"].values()) + list(opt.state["nu"].values())
              if "mu" in opt.state else [t for s in opt.state.values() for t in s.values()
                                         if torch.is_tensor(t) and t.dim()])
    assert states and all(t.dtype == torch.float32 for t in states)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_bf16_quality_matches_f32():
    """Same seed and random stream: the only divergence is rounding, and
    the ranking metrics after 3 epochs agree within 0.04."""
    results = {dtype: _trained({"train_epochs": ["BOTH:3"], "compute_dtype": dtype})
               ["test_result"] for dtype in ("float32", "bfloat16")}
    for key in ("recall@10", "ndcg@10", "mrr@10"):
        assert abs(results["bfloat16"][key] - results["float32"][key]) < 0.04, results


def test_bf16_host_path():
    result = _trained({"train_epochs": ["BOTH:2"], "compute_dtype": "bfloat16",
                       "device_side_sampling": False})
    assert 0.0 <= result["test_result"]["recall@10"] <= 1.0
    assert all(math.isfinite(h["loss"]) for h in result["history"])


@pytest.mark.parametrize("model,extra,kernel", [
    ("BiTGCF", {}, "B8"),
    ("NATR", {}, "B9"),
    ("DTCDR", {"base_model": "DMF"}, "B11"),
])
def test_models_without_a_bf16_kernel_raise(model, extra, kernel):
    config = CDRConfig(model=model, config_dict={**_QUICK, "compute_dtype": "bfloat16",
                                                 **extra}, _cli_args=[])
    with pytest.raises(NotImplementedError, match=f"{kernel}.*A10 remainder"):
        get_model(model)(config, CrossDomainDataset(config))
