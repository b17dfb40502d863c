"""The port's BiTGCF eval cache (the propagated target tables, computed once
per parameter version): the cases of ``tests/test_eval_cache.py`` for the
port. A cache hit serves the same tables; an optimizer step and a
``load_state_dict`` each invalidate it, and the refreshed scores equal a
fresh propagation. Also, the propagation runs once per evaluation pass, not
once per user tile."""

import numpy as np
import torch

from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.models.bitgcf import BiTGCF
from recbole_cdr_tpu_torch.trainer.trainer import (
    CrossDomainTrainer,
    build_optimizer,
    make_train_step,
)
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import train_mode2state

_CFG = {"state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 512}


def _build(extra=None):
    config = CDRConfig(model="BiTGCF", config_dict={**_CFG, **(extra or {})}, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = CrossDomainDataset(config)
    train_data, valid_data, test_data = data_preparation(config, dataset)
    return config, dataset, BiTGCF(config, dataset), train_data, valid_data, test_data


def _fresh_scores(config, dataset, state, users):
    model = BiTGCF(config, dataset)
    model.load_state_dict(state)
    with torch.no_grad():
        return model.full_sort(users)


def test_eval_cache_refreshes_after_a_step_and_a_load():
    config, dataset, model, train_data, _, _ = _build()
    users = torch.arange(1, 9)
    with torch.no_grad():
        scores_a = model.full_sort(users)
        cached = model._version_cache["eval_embeddings"]
        torch.testing.assert_close(model.full_sort(users), scores_a, rtol=0, atol=0)
    assert model._version_cache["eval_embeddings"] is cached  # a hit: no propagation

    # one optimizer step through the trainer's step function
    train_data.set_mode(train_mode2state["BOTH"])
    batch = {k: torch.from_numpy(np.asarray(v, np.int32 if v.dtype.kind == "i" else np.float32))
             for k, v in next(iter(train_data)).items()}
    v0 = model.params_version
    step = make_train_step(model, build_optimizer(config, model.parameters()),
                           model.loss_fn("BOTH"), lambda n: True)
    step(batch)
    assert model.params_version == v0 + 1
    with torch.no_grad():
        scores_b = model.full_sort(users)
    assert model._version_cache["eval_embeddings"] is not cached
    assert not torch.allclose(scores_a, scores_b)
    state_b = {k: v.clone() for k, v in model.state_dict().items()}
    torch.testing.assert_close(scores_b, _fresh_scores(config, dataset, state_b, users),
                               rtol=0, atol=0)

    # loading other parameters invalidates the cache too
    state_c = {k: 2.0 * v for k, v in state_b.items()}
    model.load_state_dict(state_c)
    assert model.params_version == v0 + 2
    with torch.no_grad():
        scores_c = model.full_sort(users)
    assert not torch.allclose(scores_b, scores_c)
    torch.testing.assert_close(scores_c, _fresh_scores(config, dataset, state_c, users),
                               rtol=0, atol=0)


def test_trainer_evaluate_serves_the_best_parameters(monkeypatch):
    """After ``fit``, ``evaluate`` loads the best validated parameters: its
    test result is a fresh model's at those parameters, not the cached
    last-epoch tables; and each evaluation pass propagates once, whatever
    its number of user tiles."""
    monkeypatch.setattr(FullSortEvaluator, "DENSE_USER_BLOCK", 16)
    config, dataset, model, train_data, valid_data, test_data = _build(
        {"train_epochs": ["BOTH:3"], "eval_batch_size": 1024})
    propagations = []
    forward = model._forward
    monkeypatch.setattr(model, "_forward",
                        lambda rng=None: propagations.append(rng) or forward(rng))
    trainer = CrossDomainTrainer(config, model)
    trainer.fit(train_data, valid_data)
    B, _ = trainer.evaluator._dense_budget(valid_data)
    assert len(valid_data.uid_list) > 2 * B  # several user tiles per pass
    steps = 3 * trainer._loops["BOTH"].steps_per_epoch
    assert sum(r is not None for r in propagations) == steps  # training, with dropout
    assert propagations.count(None) == 3  # one per validation pass
    got = trainer.evaluate(test_data)
    assert propagations.count(None) == 4  # the load of the best parameters invalidated

    fresh = BiTGCF(config, dataset)
    fresh.load_state_dict(trainer.best_params)
    fresh_trainer = CrossDomainTrainer(config, fresh)
    assert got == fresh_trainer.evaluate(test_data, load_best_model=False)
