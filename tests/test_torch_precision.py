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
- BiTGCF (BOTH, no dropout), NATR (TARGET; its frozen source tables get
  no gradient), DTCDR's DMF (BOTH), CoNet (BOTH) and DeepAPF (BOTH) take the
  same loss and gradient checks through the plain versions of the 16-bit
  forms of B8, B9, B11 and B16 (CoNet's towers train as torch products);
  the observed ratio ``|g - g_f32| / |g_jax - g_f32|`` of their matrix
  gradients is 0.90-0.92 (BiTGCF's tables), 0.96-1.40 (NATR's tables and
  weights), 1.00-1.09 (DMF's tables and tower weights), 1.00-1.18 (CoNet's
  tables, tower weights and cross matrices) and 0.67-1.01 (DeepAPF's tables,
  attention weights and predict layer), 0.000 for each with the port in
  float32. Their 16-bit evaluation against JAX's, each tolerance in units
  of u: BiTGCF's propagated tables and full-sort scores, NATR's and
  DeepAPF's predict-fallback probabilities and top-10 ids, CoNet's full-sort
  probabilities (B15's 16-bit form) and top-10 ids, DMF's tower tables and
  ``predict``; and one short schedule of each through the entry point.
- B15's and B16's wrappers refuse operands of mixed types, and their 16-bit
  forms float32 ones: a 16-bit operand never reaches a float32 kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.models.bitgcf import BiTGCF as JaxBiTGCF
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.models.conet import CoNet as JaxCoNet
from recbole_cdr_tpu.models.deepapf import DeepAPF as JaxDeepAPF
from recbole_cdr_tpu.models.dtcdr import DTCDR as JaxDTCDR
from recbole_cdr_tpu.models.emcdr import EMCDR as JaxEMCDR
from recbole_cdr_tpu.models.natr import NATR as JaxNATR
from recbole_cdr_tpu.utils.precision import with_compute_dtype as jax_with_compute_dtype

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.models.bitgcf import BiTGCF
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.models.conet import CoNet
from recbole_cdr_tpu_torch.models.deepapf import DeepAPF
from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
from recbole_cdr_tpu_torch.models.emcdr import EMCDR
from recbole_cdr_tpu_torch.models.natr import NATR
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
    "DTCDR-DMF": (JaxDTCDR, DTCDR, {"base_model": "DMF"}, "BOTH"),
    "BiTGCF": (JaxBiTGCF, BiTGCF, {"drop_rate": 0.0}, "BOTH"),
    "NATR": (JaxNATR, NATR, {}, "TARGET"),
    "CoNet": (JaxCoNet, CoNet, {}, "BOTH"),
    "DeepAPF": (JaxDeepAPF, DeepAPF, {}, "BOTH"),
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

    def jax_grads(dtype, jmodel=jmodel):
        loss_fn = jax_with_compute_dtype(jmodel.loss_fn(phase), dtype)
        return jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jbatch, None)))(jparams)

    jmodel16 = jmodel
    if jax_cls is JaxBiTGCF:  # its adjacency and degrees take the compute type at construction
        cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", **extra,
               "compute_dtype": "bfloat16"}
        jmodel16 = jax_cls(JaxConfig(model=name, config_dict=cfg, _cli_args=[]), m["jdataset"])
        jmodel16.set_phase(phase)
    jloss, jgrads = jax_grads(jnp.bfloat16, jmodel16)
    _, grads32 = jax_grads(jnp.float32)
    tmodel.zero_grad(set_to_none=True)
    tloss = with_compute_dtype(tmodel.loss_fn(phase), dtype, tmodel)(_tbatch(batch))
    tloss.backward()
    return tloss, tmodel, jloss, jgrads, grads32


def _check_bf16(tloss, tmodel, jloss, jgrads, grads32):
    assert tloss.dtype == torch.float32
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    checked = 0
    trained = tmodel.trainable_predicate(tmodel.phase)
    for pname, p in tmodel.named_parameters():
        if not trained(pname.split(".")[0]):  # frozen in the phase (NATR's source tables)
            assert p.grad is None, pname
            continue
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


def _mixed_cases():
    """(wrapper, arguments) of B16 and B15 whose floating operands are not of
    one 16-bit type, or are float32 handed to a 16-bit form."""
    from recbole_cdr_tpu_torch.ops import conet_tower as b15
    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    tabs, g = b16.Tables(*(r(6, 32) for _ in range(5))), r(6)
    w = b16.Weights(r(32, 32), r(32), r(32, 1), r(32, 1))
    w16 = b16.Weights(*(t.to(bf) for t in w))
    tabs16 = b16.Tables(*(t.to(bf) for t in tabs))
    ids = torch.arange(3, dtype=torch.int32)
    pairs = b16.Pairs(ids, ids, ids, ids)
    hu, hi, b0, layers, out = r(3, 8), r(5, 8), r(8), [(r(8, 4), r(4))], (r(4, 1), r(1))
    return {
        "forward-weights": (b16.deepapf_forward, (tabs16, pairs, 2, w)),
        "backward-gradient": (b16.deepapf_backward, (tabs16, pairs, 2, w16, g)),
        "backward-fp16-row": (b16.deepapf_backward,
                              (tabs16._replace(other_tgt=tabs.other_tgt.half()), pairs, 2, w16,
                               g.to(bf))),
        "grid-tables": (b16.deepapf_grid, (tabs16.share, tabs16.only_tgt, tabs.other_tgt, ids,
                                           ids, 2, True, w16)),
        "grid_bf16-float32": (b16.deepapf_grid_bf16, (tabs.share, tabs.only_tgt,
                                                      tabs.other_tgt, ids, ids, 2, True, w)),
        "tower-layers": (b15.conet_tower, (hu.to(bf), hi.to(bf), b0.to(bf), layers,
                                           tuple(t.to(bf) for t in out))),
        "tower_bf16-float32": (b15.conet_tower_bf16, (hu, hi, b0, layers, out)),
    }


@pytest.mark.parametrize("case", ["forward-weights", "backward-gradient", "backward-fp16-row",
                                  "grid-tables", "grid_bf16-float32", "tower-layers",
                                  "tower_bf16-float32"])
def test_b16_and_b15_reject_mixed_types(case):
    """B16's and B15's wrappers dispatch on the operands' type (float32 to
    the float32 kernel, 16-bit to the 16-bit instances) and raise a
    ``TypeError`` for operands of mixed types, and their 16-bit forms for
    float32 ones, before any launch: the same check runs on the CPU, so a
    16-bit operand never reaches a float32 kernel on the card."""
    from recbole_cdr_tpu_torch import ops

    fn, args = _mixed_cases()[case]
    ops.reset_launch_counts()
    with pytest.raises(TypeError, match="one type of"):
        fn(*args)
    assert not any(ops.launch_counts().values())


# ------------------------------------------------- 16-bit evaluation vs JAX

def _eval_models(name, extra=None, params_fn=None):
    """The JAX and the port's model in evaluation on the same weights, the
    JAX one built under ``compute_dtype: bfloat16`` (BiTGCF's adjacency
    takes it at construction)."""
    jax_cls, torch_cls, base, _ = _MODELS[name]
    m = build_pair(name.split("-")[0], jax_cls, torch_cls,
                   {**base, **(extra or {}), "compute_dtype": "bfloat16"}, params_fn)
    m["tmodel"].eval()
    m["jparams"] = jax.tree_util.tree_map(jnp.asarray, m["params"])
    return m


def test_bf16_bitgcf_eval_matches_jax():
    """BiTGCF's propagated target tables and its full-sort scores under bf16
    against JAX's (``_eval_embeddings`` and ``full_sort_fn``, which cast
    inside the cached propagation): both 16-bit. Both sides round each
    layer's 16-bit values at other points (XLA fuses the transfer layer's
    elementwise chain, torch rounds per operation; B8's plain version sums a
    row in float32 and rounds once), so a propagated value differs by at most
    ``2u`` (seen 1.5u; the normalised layers' values are below 1), and a
    score by at most ``2u`` times the sum of its products' magnitudes (seen
    1.13 of ``u`` times it)."""
    m = _eval_models("BiTGCF")
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    jmodel.set_phase("TARGET")
    tmodel.set_phase("TARGET")
    want = [np.asarray(t.astype(jnp.float32)) for t in jmodel._eval_embeddings(m["jparams"])]
    with torch.no_grad():
        got = with_compute_dtype(lambda: tmodel._eval_embeddings(), torch.bfloat16, tmodel)()
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= 2 * U_BF16
    users = np.arange(1, 65)
    js = np.asarray(jmodel.full_sort_fn("TARGET")(m["jparams"], jnp.asarray(users))
                    .astype(jnp.float32))
    with torch.no_grad():
        ts = with_compute_dtype(tmodel.full_sort_fn("TARGET"), torch.bfloat16,
                                tmodel)(torch.from_numpy(users))
    assert ts.dtype == torch.bfloat16 and ts.shape == js.shape
    chain = np.abs(want[0][users]) @ np.abs(want[1][:js.shape[1]]).T
    assert np.all(np.abs(ts.float().numpy() - js) <= 2 * U_BF16 * chain)


def _scaled_tables(jmodel, params, factor=4):
    """The initial weights with the model's embedding tables scaled by
    ``factor``, so that the probabilities spread (NATR's over about (0.19,
    0.82) at 4) rather than lying within a few bf16 steps of 0.5, where
    whole rows tie."""
    return {k: v * factor if k.endswith("_embedding") else v for k, v in params.items()}


def _assert_top10_match(got, want, k=10):
    """Top-``k`` ids of the 16-bit probabilities ``got`` through K4's plain
    version, with the PAD column masked as the evaluator does: K4 breaks ties
    as ``lax.top_k`` does (lower index first), exactly, on the port's own
    probabilities; against JAX's ids (``want``'s), equal wherever JAX's
    neighbouring top scores differ by more than ``4u``, and at every rank the
    two lists' items score within ``4u`` of each other under JAX's
    probabilities."""
    from recbole_cdr_tpu_torch.ops.masked_topk import masked_topk_plain

    want = want.copy()
    lowest = float(np.finfo(np.float32).min)
    want[:, 0] = lowest
    masked = got.clone()
    masked[:, 0] = lowest
    no_history = (torch.zeros(got.shape[0] + 1, dtype=torch.int32),
                  torch.zeros(0, dtype=torch.int32))
    ids = masked_topk_plain(got, *no_history, k).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jax.lax.top_k(jnp.asarray(masked.numpy()), k)[1]))
    jids = np.asarray(jax.lax.top_k(jnp.asarray(want), k)[1])
    top = np.take_along_axis(want, jids, 1)
    after = -np.sort(-want, 1)[:, k]
    apart = np.abs(np.diff(np.concatenate([top, after[:, None]], 1), axis=1)) > 4 * U_BF16
    clear = apart.copy()
    clear[:, 1:] &= apart[:, :-1]
    assert clear.any()
    np.testing.assert_array_equal(ids[clear], jids[clear])
    assert np.all(np.abs(np.take_along_axis(want, ids, 1) - top) <= 4 * U_BF16)


def test_bf16_natr_grid_and_ids_match_jax():
    """NATR's predict fallback under bf16 (B9's 16-bit anchor table and pair
    grid, plain on the CPU) against JAX's ``make_predict_full_sort`` under
    bf16: 16-bit probabilities within ``2u`` of JAX's (two bf16 steps of a
    probability; seen 2u at most, a third of them apart by one step: the
    two sides round the attention's intermediates at other points). The
    top-10 ids through K4's plain version, with the PAD column masked as the
    evaluator does: K4 breaks ties as ``lax.top_k`` does (lower index first),
    exactly, on the port's own probabilities; against JAX's ids, equal
    wherever JAX's neighbouring top scores differ by more than ``4u`` (twice
    the tolerance), and at every rank the two lists' items score within
    ``4u`` of each other under JAX's probabilities."""
    from recbole_cdr_tpu.trainer.trainer import make_predict_full_sort as jax_predict_full_sort

    from recbole_cdr_tpu_torch.trainer.trainer import make_predict_full_sort

    m = _eval_models("NATR", params_fn=_scaled_tables)
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    jmodel.set_phase("TARGET")
    tmodel.set_phase("TARGET")
    item_num, users, k = m["ttest"].item_num, np.arange(1, 65), 10
    want = jax_predict_full_sort(jmodel, "TARGET", item_num, compute_dtype=jnp.bfloat16)(
        m["jparams"], jnp.asarray(users))
    assert want.dtype == jnp.bfloat16
    want = np.array(want.astype(jnp.float32))
    with torch.no_grad():
        got = make_predict_full_sort(tmodel, item_num, torch.bfloat16)(torch.from_numpy(users))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float()
    assert np.abs(got.numpy() - want).max() <= 2 * U_BF16
    _assert_top10_match(got, want, k)


def test_bf16_conet_full_sort_matches_jax():
    """CoNet's full-sort under bf16 (B15's 16-bit form, plain on the CPU,
    with the item half cached in bf16) against JAX's ``full_sort_fn`` under
    its cast on users 1-64, the tables scaled by 16 so that the
    probabilities spread over about (0.21, 0.90): 16-bit probabilities
    within ``2u`` of JAX's (two bf16 steps of a probability above 0.5; seen
    1u, 27% of them a step apart: XLA on the CPU rounds the sigmoid's
    ``exp(-z)``, ``1 + exp(-z)`` and quotient each to bf16 where the port
    rounds the sigmoid once; rounded as XLA does, the port's probabilities
    come out the same, whichever order ``b0`` is added in), and the top-10
    ids as :func:`_assert_top10_match`."""
    from recbole_cdr_tpu.utils.precision import with_compute_dtype as jax_cast

    m = _eval_models("CoNet", params_fn=lambda j, p: _scaled_tables(j, p, 16))
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    users = np.arange(1, 65)
    want = jax_cast(jmodel.full_sort_fn("TARGET"), jnp.bfloat16)(m["jparams"],
                                                                 jnp.asarray(users))
    assert want.dtype == jnp.bfloat16
    want = np.array(want.astype(jnp.float32))
    with torch.no_grad():
        got = with_compute_dtype(tmodel.full_sort_fn("TARGET"), torch.bfloat16,
                                 tmodel)(torch.from_numpy(users))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert tmodel._version_cache[f"item_half:{torch.bfloat16}"][1].dtype == torch.bfloat16
    got = got.float()
    assert np.abs(got.numpy() - want).max() <= 2 * U_BF16
    _assert_top10_match(got, want)


def test_bf16_deepapf_grid_and_ids_match_jax():
    """DeepAPF's predict fallback under bf16 (B16's 16-bit grid, plain on the
    CPU) against JAX's ``make_predict_full_sort`` under bf16 on users 1-64,
    the tables scaled by 4 so that the probabilities spread over about
    (0.37, 0.62): 16-bit probabilities within ``2u`` of JAX's (seen 1u, a
    third of them a step apart: the two sides round the attention's sums at
    other points), and the top-10 ids as :func:`_assert_top10_match`."""
    from recbole_cdr_tpu.trainer.trainer import make_predict_full_sort as jax_predict_full_sort

    from recbole_cdr_tpu_torch.trainer.trainer import make_predict_full_sort

    m = _eval_models("DeepAPF", params_fn=_scaled_tables)
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    item_num, users = m["ttest"].item_num, np.arange(1, 65)
    want = jax_predict_full_sort(jmodel, "TARGET", item_num, compute_dtype=jnp.bfloat16)(
        m["jparams"], jnp.asarray(users))
    assert want.dtype == jnp.bfloat16
    want = np.array(want.astype(jnp.float32))
    with torch.no_grad():
        got = make_predict_full_sort(tmodel, item_num, torch.bfloat16)(torch.from_numpy(users))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float()
    assert np.abs(got.numpy() - want).max() <= 2 * U_BF16
    _assert_top10_match(got, want)


def test_bf16_dmf_predict_and_towers_match_jax():
    """DTCDR's DMF under bf16: the rating-vector products sum 16-bit table
    rows in float32 (B11's 16-bit form) and the towers run float32 on the
    upcast weights, as JAX promotes ``float32 @ bf16``, so the tower tables
    and ``predict`` are float32 and agree with JAX's to float32 rounding:
    within ``u^2`` (2^-16) of the largest value (seen 3e-7 relative)."""
    from recbole_cdr_tpu.utils.precision import cast_floats as jax_cast_floats

    m = _eval_models("DTCDR-DMF")
    jmodel, tmodel = m["jmodel"], m["tmodel"]
    p16 = jax_cast_floats(m["jparams"], jnp.bfloat16)
    towers = []
    for side, n, hists in (("user", tmodel.target_num_users,
                            ((jmodel._s_hist_items, jmodel.source_num_items, "source"),
                             (jmodel._t_hist_items, jmodel.target_num_items, "target"))),
                           ("item", tmodel.target_num_items,
                            ((jmodel._s_hist_users, jmodel.source_num_users, "source"),
                             (jmodel._t_hist_users, jmodel.target_num_users, "target")))):
        ids = jnp.arange(n)
        e = jnp.maximum(*(jmodel._rating_vector(h, ids, length) @ p16[f"{d}_{side}_linear"]
                          for h, length, d in hists))
        towers.append(np.asarray(jmodel._plain_mlp(p16[f"target_{side}_fc"], e)))
    with torch.no_grad():
        got = with_compute_dtype(lambda: tmodel._tower_tables(), torch.bfloat16, tmodel)()
    for w, g in zip(towers, got):
        assert w.dtype == np.float32 and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=U_BF16 ** 2 * np.abs(w).max())
    users, items = np.repeat(np.arange(1, 33), 50), np.tile(np.arange(1, 51), 32)
    keys = (tmodel.TARGET_USER_ID, tmodel.TARGET_ITEM_ID)
    want = np.asarray(jax_with_compute_dtype(jmodel.predict_fn(), jnp.bfloat16)(
        m["jparams"], dict(zip(keys, (jnp.asarray(users), jnp.asarray(items))))))
    with torch.no_grad():
        got = with_compute_dtype(tmodel.predict, torch.bfloat16, tmodel)(
            dict(zip(keys, (torch.from_numpy(users).int(), torch.from_numpy(items).int()))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=U_BF16 ** 2)


#: one short schedule per model through the entry point under bf16, NATR's
#: SOURCE then TARGET also on the sparse step (K1's 16-bit form on the
#: gathered sub-tables)
@pytest.mark.parametrize("model,extra", [
    pytest.param("BiTGCF", {"train_epochs": ["BOTH:1"]}, id="BiTGCF"),
    pytest.param("DTCDR", {"base_model": "DMF", "train_epochs": ["BOTH:1"]}, id="DTCDR-DMF"),
    pytest.param("NATR", {"train_epochs": ["SOURCE:1", "TARGET:1"]}, id="NATR"),
    pytest.param("NATR", {"train_epochs": ["SOURCE:1", "TARGET:1"], "phase_optimizer": "sparse"},
                 id="NATR-sparse"),
    pytest.param("CoNet", {"train_epochs": ["BOTH:1"]}, id="CoNet"),
    pytest.param("DeepAPF", {"train_epochs": ["BOTH:1"]}, id="DeepAPF"),
])
def test_bf16_models_train_on_cpu(model, extra):
    """The analogue of ``tests/test_precision.py::test_all_models_train_bf16``:
    finite losses and test metrics in [0, 1], float32 master parameters."""
    result = run_recbole_cdr(model=model, config_dict={**_QUICK, "compute_dtype": "bfloat16",
                                                        **extra})
    assert [h["phase"] for h in result["history"]] == [e.split(":")[0]
                                                       for e in extra["train_epochs"]]
    assert all(math.isfinite(h["loss"]) for h in result["history"])
    for key in ("recall@10", "mrr@10", "ndcg@10"):
        assert 0.0 <= result["test_result"][key] <= 1.0, result["test_result"]
    assert all(p.dtype == torch.float32 for p in result["model"].parameters())
