"""GAUC in the PyTorch port against the JAX package, on the CPU (where kernel
B7's wrapper runs its plain version).

- B7's plain version equals ``_pos_rank_sum`` on the row
  ``_apply_masks_pairs`` masks, exactly: every rank is a half-integer and
  every sum stays far below 2^23, so float32 is exact in any order. The
  inputs carry ties, history (duplicates included), ``-inf`` scores in and
  out of the history, the PAD column, padded positives, rows without
  positives and positives inside the history.
- The port's GAUC and top-k metrics equal the JAX evaluator's on CMF with
  the same weights, at the metric's decimal place (the weights are multiples
  of 1/64, so both packages' scores are the same float32 values).
- The streaming evaluator refuses GAUC, and the trainer routes GAUC to the
  dense path whatever the streaming threshold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.evaluator.evaluator import FullSortEvaluator as JaxEvaluator
from recbole_cdr_tpu.evaluator.evaluator import _apply_masks_pairs, _pos_rank_sum
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.utils import init_seed as jax_init_seed

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.ops.rank_sum import rank_sum, rank_sum_plain
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax

METRICS = ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]


def _rank_inputs(seed, B, I, P, integer):
    rng = np.random.default_rng(seed)
    if integer:
        scores = rng.integers(-3, 4, (B, I)).astype(np.float32)  # ties everywhere
    else:
        scores = rng.normal(size=(B, I)).astype(np.float32)
    scores[rng.random((B, I)) < 0.02] = -np.inf
    hist = [rng.choice(I, rng.integers(0, I // 4), replace=True) for _ in range(B)]
    hist[0] = np.array([], np.int64)
    pos = rng.integers(0, I, (B, P))
    pmask = rng.random((B, P)) < 0.6
    pmask[1] = False                                   # no positives
    pos[2, 0], pmask[2, 0] = 0, True                   # the PAD column
    if len(hist[3]):
        pos[3, 0], pmask[3, 0] = hist[3][0], True      # a positive inside the history
        scores[3, hist[3][0]] = -np.inf                # ... holding -inf
    return scores, hist, pos.astype(np.int32), pmask


@pytest.mark.parametrize("seed,B,I,P,integer", [(0, 37, 211, 7, True), (1, 9, 1000, 13, False),
                                                (2, 5, 40, 1, True)])
def test_rank_sum_plain_equals_pos_rank_sum(seed, B, I, P, integer):
    scores, hist, pos, pmask = _rank_inputs(seed, B, I, P, integer)
    lens = np.array([len(h) for h in hist])
    hrows = np.repeat(np.arange(B), lens).astype(np.int32)
    hitems = np.concatenate(hist).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda s, r, i, p, m: _pos_rank_sum(_apply_masks_pairs(s, r, i, jnp.ones(i.shape, bool)),
                                            p, m)
    )(jnp.asarray(scores), jnp.asarray(hrows), jnp.asarray(hitems), jnp.asarray(pos),
      jnp.asarray(pmask)))

    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    args = (torch.from_numpy(scores), row_ptr, torch.from_numpy(hitems),
            torch.from_numpy(pos), torch.from_numpy(pmask))
    got = rank_sum_plain(*args).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rank_sum(*args).numpy(), want)
    assert got[1] == 0.0


def _cmf(extra=None):
    cfg = {"state": "ERROR", "device": "cpu", "metrics": METRICS, "topk": [5, 10],
           **(extra or {})}
    jconfig = JaxConfig(model="CMF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    _, _, jtest = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxCMF(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(3)))
    params = {k: (np.round(np.asarray(v) * 64) / 64).astype(np.float32)
              for k, v in params.items()}
    tconfig = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    _, _, ttest = data_preparation(tconfig, tdataset)
    model = CMF(tconfig, tdataset)
    model.load_state_dict(params_from_jax(params))
    return jconfig, jmodel, params, jtest, tconfig, model, ttest


@pytest.mark.parametrize("block", [None, 16])
def test_gauc_matches_jax_evaluator(block, monkeypatch):
    """``block=16`` cuts the users into many tiles and segments: the rank
    sums must still line up with their users."""
    jconfig, jmodel, params, jtest, tconfig, model, ttest = _cmf()
    want = JaxEvaluator(jconfig).evaluate(jax.jit(jmodel.full_sort_fn("BOTH")), params, jtest)
    if block is not None:
        monkeypatch.setattr(FullSortEvaluator, "DENSE_USER_BLOCK", block)
        monkeypatch.setattr(FullSortEvaluator, "DENSE_SEG_ELEMS", 3 * block * ttest.item_num)
        ttest.user_batch = block
    got = FullSortEvaluator(tconfig).evaluate(lambda users: model.full_sort(users), ttest, "cpu")
    assert got == want
    assert 0 < got["gauc"] < 1


def test_streaming_refuses_gauc_and_the_trainer_routes_it_dense():
    _, _, _, _, tconfig, model, ttest = _cmf()
    with pytest.raises(ValueError, match="GAUC"):
        FullSortEvaluator(tconfig).evaluate_streaming(model.full_sort_factors(), ttest, "cpu")
    result = run_recbole_cdr(model="CMF", config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 2048,
        "train_epochs": ["BOTH:1"], "metrics": METRICS, "streaming_topk_threshold": 1})
    assert math.isfinite(result["test_result"]["gauc"])
