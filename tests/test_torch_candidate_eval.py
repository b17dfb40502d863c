"""Candidate-ranking (``uniform N`` / ``popularity N``) and labeled
evaluation in the PyTorch port against the JAX package, on the CPU (where
kernel B10's and B7's candidate-form wrappers run their plain versions), on
the bundled ml-1m -> ml-100k pair.

- ``CandidateEvalBatches`` and ``LabeledEvalBatches``: the same arrays as
  JAX's for the same seed (the host samplers are the same numpy code);
- B10's plain version against ``_candidate_topk`` and the candidate B7
  against ``_pos_rank_sum`` over ``np.where(cand_mask, scores, -inf)``:
  exactly equal, with ties, padded slots, fully padded rows and positives at
  column 0;
- ``evaluate_candidates`` and ``ValueEvaluator`` from JAX's initial CMF and
  DTCDR weights carried across: the metric dicts (rounded to 4 decimals, as
  both packages report them) equal JAX's;
- the entry point in both modes.
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
from recbole_cdr_tpu.evaluator.evaluator import ValueEvaluator as JaxValueEvaluator
from recbole_cdr_tpu.evaluator.evaluator import _candidate_topk, _pos_rank_sum
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.models.dtcdr import DTCDR as JaxDTCDR
from recbole_cdr_tpu.utils import init_seed as jax_init_seed

from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator, ValueEvaluator
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
from recbole_cdr_tpu_torch.ops.candidate_topk import candidate_topk
from recbole_cdr_tpu_torch.ops.rank_sum import rank_sum_candidates
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax


def _eval_args(mode):
    return {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "RO", "mode": mode}


CANDIDATE = {"eval_args": _eval_args("uniform 20"), "eval_batch_size": 2048,
             "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC", "ItemCoverage",
                         "AveragePopularity"]}
LABELED = {"eval_args": _eval_args("labeled"), "threshold": {"rating": 4},
           "source_val_interval": None, "target_val_interval": None,
           "metrics": ["AUC", "MAE", "RMSE", "LogLoss"], "valid_metric": "AUC"}


def _prepare(model, extra):
    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu", **extra}
    jconfig = JaxConfig(model=model, config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jdata = jax_data_preparation(jconfig, jdataset)
    tconfig = CDRConfig(model=model, config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    tdata = data_preparation(tconfig, tdataset)
    return jconfig, jdataset, jdata, tconfig, tdataset, tdata


@pytest.mark.parametrize("mode", ["uniform 20", "popularity 20"])
def test_candidate_batches_equal_jax(mode):
    """The valid and test candidate lists, masks and positives, batch by
    batch, as JAX builds them from the same seed."""
    *_, jdata, _, _, tdata = _prepare("CMF", {"eval_args": _eval_args(mode)})
    for jb, tb in ((jdata[1], tdata[1]), (jdata[2], tdata[2])):
        assert tb.is_candidate and len(tb) == len(jb) > 0
        assert (tb.max_cand, tb.user_batch) == (jb.max_cand, jb.user_batch)
        np.testing.assert_array_equal(tb.train_item_counts, jb.train_item_counts)
        for want, got in zip(jb, tb):
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)


def test_labeled_batches_equal_jax_and_source_phase_raises():
    """The labeled triples as JAX's; ``labeled`` with a SOURCE phase raises
    as in JAX."""
    *_, jdata, _, _, tdata = _prepare("CMF", LABELED)
    for jb, tb in ((jdata[1], tdata[1]), (jdata[2], tdata[2])):
        assert tb.is_labeled and len(tb) == len(jb) > 0
        for want, got in zip(jb, tb):
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g, w)
    cfg = {"state": "ERROR", "device": "cpu", "train_epochs": ["SOURCE:1", "TARGET:1"],
           **LABELED}
    tconfig = CDRConfig(model="NATR", config_dict=cfg, _cli_args=[])
    with pytest.raises(NotImplementedError, match="SOURCE training phase"):
        data_preparation(tconfig, CrossDomainDataset(tconfig))


def _candidate_inputs(rng, B, C, integer):
    scores = (rng.integers(-3, 4, (B, C)) if integer else rng.normal(size=(B, C)))
    lens = rng.integers(1, C + 1, B)
    lens[0], lens[1] = C, 0              # a full row and a fully padded one
    cand_mask = np.arange(C)[None, :] < lens[:, None]
    n_pos = np.minimum(rng.integers(1, 4, B), lens)
    pos_mask = np.arange(C)[None, :] < n_pos[:, None]  # positives first: column 0 is one
    return scores.astype(np.float32), cand_mask, pos_mask


@pytest.mark.parametrize("B,C,k,integer", [(64, 120, 10, True), (64, 120, 10, False),
                                           (9, 7, 7, True), (5, 1, 1, False)])
def test_candidate_topk_and_rank_sum_plain_equal_jax(B, C, k, integer):
    """B10's plain version equals ``_candidate_topk`` and the candidate B7
    equals ``_pos_rank_sum`` exactly (numpy seed 11), with ties everywhere
    in the integer case, padded slots, a fully padded row, k = C and a
    positive at column 0 of every row that has one."""
    scores, cand_mask, pos_mask = _candidate_inputs(np.random.default_rng(11), B, C, integer)
    want_ids = np.asarray(_candidate_topk(jnp.asarray(scores), jnp.asarray(cand_mask), k))
    masked = np.where(cand_mask, scores, -np.inf)
    cols = np.broadcast_to(np.arange(C), (B, C)).copy()
    want_rs = np.asarray(_pos_rank_sum(jnp.asarray(masked), jnp.asarray(cols),
                                       jnp.asarray(pos_mask)))
    ops.reset_launch_counts()
    s, cm, pm = (torch.from_numpy(a) for a in (scores, cand_mask, pos_mask))
    np.testing.assert_array_equal(candidate_topk(s, cm, k).numpy(), want_ids)
    np.testing.assert_array_equal(rank_sum_candidates(s, cm, pm).numpy(), want_rs)
    assert ops.launch_counts()["candidate_topk"] == ops.launch_counts()["rank_sum_candidates"] == 0
    with pytest.raises(ValueError, match="k <= min"):
        candidate_topk(s, cm, C + 1)


def _carried(model, extra):
    """JAX's and the port's model of ``model`` from JAX's initial weights,
    with their test eval sets."""
    jconfig, jdataset, jdata, tconfig, tdataset, tdata = _prepare(model, extra)
    jcls, tcls = {"CMF": (JaxCMF, CMF), "DTCDR": (JaxDTCDR, DTCDR)}[model]
    jmodel = jcls(jconfig, jdataset)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))
    tmodel = tcls(tconfig, tdataset)
    tmodel.load_state_dict(params_from_jax(params))
    tmodel.eval()
    return jconfig, jmodel, params, jdata[2], tconfig, tmodel, tdata[2]


def _assert_same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("model,extra", [("CMF", {}), ("DTCDR", {"base_model": "DMF"}),
                                         ("DTCDR", {"base_model": "NeuMF"})])
def test_evaluate_candidates_matches_jax(model, extra):
    """``uniform 20`` evaluation of the test split, every ranking metric,
    GAUC and two non-accuracy metrics, from the same weights."""
    jconfig, jmodel, params, jtest, tconfig, tmodel, ttest = _carried(
        model, {**CANDIDATE, **extra})
    uid, iid = tmodel.TARGET_USER_ID, tmodel.TARGET_ITEM_ID
    want = JaxEvaluator(jconfig).evaluate_candidates(jmodel.predict_fn(), params, jtest, uid, iid)
    got = FullSortEvaluator(tconfig).evaluate_candidates(tmodel.predict, ttest, "cpu", uid, iid)
    assert {"gauc", "recall@10", "itemcoverage@10", "averagepopularity@10"} <= set(got)
    _assert_same_metrics(got, want)


@pytest.mark.parametrize("model,extra", [("CMF", {}), ("DTCDR", {"base_model": "DMF"})])
def test_value_evaluator_matches_jax(model, extra):
    """``labeled`` evaluation of the test split from the same weights."""
    jconfig, jmodel, params, jtest, tconfig, tmodel, ttest = _carried(model, {**LABELED, **extra})
    uid, iid = tmodel.TARGET_USER_ID, tmodel.TARGET_ITEM_ID
    want = JaxValueEvaluator(jconfig).evaluate(jmodel.predict_fn(), params, jtest, uid, iid)
    got = ValueEvaluator(tconfig).evaluate(tmodel.predict, ttest, "cpu", uid, iid)
    assert set(got) == {"auc", "mae", "rmse", "logloss"}
    _assert_same_metrics(got, want)


@pytest.mark.parametrize("model,extra", [("CMF", CANDIDATE),
                                         ("DTCDR", {**CANDIDATE, "base_model": "DMF"}),
                                         ("DTCDR", {**LABELED, "base_model": "DMF"}),
                                         ("BiTGCF", LABELED)])
def test_run_recbole_cdr_candidate_and_labeled_modes(model, extra):
    """BOTH:2 through the entry point: every validation and the test pass
    go to the mode's evaluator; the metrics pass the JAX tests' range
    checks (``tests/test_candidate_eval.py``, ``tests/test_labeled_eval.py``)."""
    cfg = {"state": "ERROR", "show_progress": False, "device": "cpu",
           "train_batch_size": 2048, "train_epochs": ["BOTH:2"], **extra}
    result = run_recbole_cdr(model=model, config_dict=cfg)
    res = result["test_result"]
    assert all(math.isfinite(v) for v in res.values())
    hist = result["history"]
    assert all("valid_seconds" in h and h["valid_users"] > 0 for h in hist)
    if "auc" in res:
        assert 0.0 <= res["auc"] <= 1.0
        assert res["rmse"] >= res["mae"] >= 0.0 and res["logloss"] > 0.0
    else:
        assert 0.0 <= res["hit@10"] <= 1.0 and 0 < res["gauc"] < 1
    assert result["test_users"] > 0
