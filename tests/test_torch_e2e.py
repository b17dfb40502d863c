"""End to end through the port's entry point on the CPU: run_recbole_cdr on
the bundled pair trains CMF and evaluates with finite metrics, the options
that raised until they were ported (bf16 compute and scores, adagrad,
rmsprop, popularity negatives, a one-rank mesh) run, and the parts not
ported yet raise instead of running something else."""

import math

import pytest

from recbole_cdr_tpu_torch import run_recbole_cdr

_QUICK = {"state": "ERROR", "show_progress": False, "device": "cpu",
          "train_batch_size": 1024}


@pytest.mark.parametrize("extra", [
    {"train_epochs": ["BOTH:2"]},
    {"train_epochs": ["BOTH:2"], "clip_grad_norm": {"max_norm": 1.0}, "weight_decay": 1e-4},
    {"train_epochs": ["BOTH:1", "BOTH:1"], "phase_optimizer": "per_phase", "learner": "sgd"},
    {"train_epochs": ["BOTH:2"], "phase_optimizer": "sparse", "streaming_topk_threshold": 1},
    {"train_epochs": ["BOTH:2"], "device_side_sampling": False},  # the host batch path
])
def test_run_recbole_cdr_cmf_on_cpu(extra):
    result = run_recbole_cdr(model="CMF", config_dict={**_QUICK, **extra})
    test = result["test_result"]
    assert set(test) == {"recall@10", "mrr@10", "ndcg@10", "hit@10", "precision@10"}
    assert all(math.isfinite(v) for v in test.values())
    assert all(math.isfinite(v) for v in result["best_valid_result"].values())
    assert len(result["history"]) == 2
    assert all(math.isfinite(h["loss"]) and h["train_examples"] > 0 for h in result["history"])


#: the configurations that raised until their code was ported: each now
#: runs (bf16 compute, the optax-form learners, bf16 streaming scores,
#: popularity negatives on the pointwise and the pairwise stream, a one-rank
#: mesh: a gloo group in this process, which the run destroys; BiTGCF,
#: CoNet and DeepAPF under bf16 compute, with the ids they had among the
#: raising cases)
@pytest.mark.parametrize("model,extra", [
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"], "loss_type": "BPR",
               "latent_factor_model": "BPR", "neg_sampling": {"popularity": 1}}),
    ("CMF", {"compute_dtype": "bfloat16"}),
    ("CMF", {"learner": "adagrad"}),
    ("CMF", {"learner": "rmsprop"}),
    ("CMF", {"streaming_topk_threshold": 10, "eval_score_dtype": "bfloat16"}),
    ("CMF", {"neg_sampling": {"popularity": 1}}),
    ("CMF", {"mesh_shape": {"data": 1, "model": 1}}),
    pytest.param("BiTGCF", {"compute_dtype": "bfloat16"}, id="BiTGCF-bf16"),
    pytest.param("CoNet", {"compute_dtype": "bfloat16"}, id="CoNet-bf16"),
    pytest.param("DeepAPF", {"compute_dtype": "bfloat16"}, id="DeepAPF-bf16"),
])
def test_ported_options_run(model, extra):
    result = run_recbole_cdr(model=model,
                             config_dict={**_QUICK, "train_epochs": ["BOTH:1"], **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    assert all(math.isfinite(h["loss"]) for h in result["history"])


#: the cases that still raise keep the ids they had among the ones that
#: moved to ``test_ported_options_run``
@pytest.mark.parametrize("model,extra", [
    pytest.param("CMF", {"mesh_shape": {"data": 1, "model": 1}, "phase_optimizer": "sparse"},
                 id="CMF-extra2"),
    pytest.param("CMF", {"phase_optimizer": "sparse", "profile_steps": 1}, id="CMF-extra3"),
    pytest.param("CMF", {"resume_checkpoint_path": "saved/CMF.pth"}, id="CMF-extra7"),
])
def test_unported_options_raise(model, extra):
    with pytest.raises(NotImplementedError):
        run_recbole_cdr(model=model, config_dict={**_QUICK, "train_epochs": ["BOTH:1"], **extra})
