"""``log_wandb`` in the port's trainer against the JAX trainer's, on the
CPU, without the wandb package: a stub module in ``sys.modules["wandb"]``
records ``init`` and ``log``; with the import failing the trainer warns
"wandb logging disabled: ..." and the run completes."""

import logging
import math
import sys
import types

import pytest

from recbole_cdr_tpu.quick_start import run_recbole_cdr as jax_run_recbole_cdr

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.trainer.trainer import CrossDomainTrainer

_CFG = {"state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 2048,
        "train_epochs": ["BOTH:2"], "log_wandb": True}


def _stub():
    wandb = types.ModuleType("wandb")
    wandb.inits, wandb.logs = [], []
    wandb.init = lambda **kwargs: wandb.inits.append(kwargs)
    wandb.log = lambda row: wandb.logs.append(dict(row))
    return wandb


def test_wandb_logs_the_keys_jax_logs(monkeypatch):
    """``init`` once with the project and the run's config; per epoch the
    phase's loss with the epoch index, per validation every metric, in the
    order and under the keys the JAX trainer logs them."""
    runs = {}
    for name, run in (("port", run_recbole_cdr), ("jax", jax_run_recbole_cdr)):
        stub = _stub()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        run(model="CMF", config_dict=dict(_CFG))
        runs[name] = stub
    port, jax_ = runs["port"], runs["jax"]
    assert len(port.inits) == len(jax_.inits) == 1
    assert port.inits[0]["project"] == jax_.inits[0]["project"] == "recbole_cdr_tpu"
    assert port.inits[0]["config"]["log_wandb"] is True
    assert [sorted(row) for row in port.logs] == [sorted(row) for row in jax_.logs]
    assert sorted(port.logs[0]) == ["epoch", "train/BOTH_loss"]
    assert sorted(port.logs[1]) == sorted(f"valid/{m}@10" for m in
                                          ("recall", "mrr", "ndcg", "hit", "precision"))
    assert [row.get("epoch") for row in port.logs if "epoch" in row] == [0, 1]
    assert all(math.isfinite(v) for row in port.logs for v in row.values())


def test_wandb_absent_warns_and_runs(monkeypatch, caplog):
    """With the import failing, the trainer warns and trains and evaluates
    as without ``log_wandb``."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    config = CDRConfig(model="CMF", config_dict=dict(_CFG), _cli_args=[])
    dataset = CrossDomainDataset(config)
    train_data, valid_data, test_data = data_preparation(config, dataset)
    with caplog.at_level(logging.WARNING):
        trainer = CrossDomainTrainer(config, CMF(config, dataset))
    assert any("wandb logging disabled:" in r.getMessage() for r in caplog.records)
    assert trainer._wandb is None
    trainer.fit(train_data, valid_data, verbose=False)
    assert all(math.isfinite(v) for v in trainer.evaluate(test_data).values())
    assert len(trainer.history) == 2


@pytest.mark.parametrize("log_wandb", [False, None])
def test_wandb_off_never_imports(monkeypatch, log_wandb):
    """Without ``log_wandb`` the trainer never touches the module."""
    stub = _stub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    result = run_recbole_cdr(model="CMF", config_dict={**_CFG, "log_wandb": log_wandb,
                                                      "train_epochs": ["BOTH:1"]})
    assert stub.inits == stub.logs == []
    assert all(math.isfinite(v) for v in result["test_result"].values())
