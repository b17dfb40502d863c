"""Model / trainer registries.

Capability parity with ``get_model`` / ``get_trainer``
(`recbole_cdr/utils/utils.py:16-59`) for every model of the reference:
CMF, CLFM, BiTGCF, CoNet, DeepAPF, NATR, DTCDR, DCDCSR, EMCDR and SSCDR. A
model trains with ``<Model>Trainer`` where ``recbole_cdr_tpu_torch.trainer``
has one (DCDCSR), else with the generic :class:`CrossDomainTrainer`.
"""

import importlib

#: model name -> module under ``recbole_cdr_tpu_torch.models``
_PORTED = {"CMF": "cmf", "CLFM": "clfm", "BiTGCF": "bitgcf", "CoNet": "conet",
           "DeepAPF": "deepapf", "NATR": "natr", "DTCDR": "dtcdr", "DCDCSR": "dcdcsr",
           "EMCDR": "emcdr", "SSCDR": "sscdr"}


def get_model(model_name: str):
    """Resolve a model name (e.g. ``"CMF"``) to its model class."""
    if model_name not in _PORTED:
        raise ValueError(f"Model [{model_name}] not found")
    module = importlib.import_module(
        f"recbole_cdr_tpu_torch.models.{_PORTED[model_name]}"
    )
    return getattr(module, model_name)


def get_trainer(model_type, model_name: str):
    """Resolve the trainer class for a model: ``<Model>Trainer`` if the
    trainer package has one, else the generic :class:`CrossDomainTrainer`
    (``recbole_cdr_tpu/utils/registry.py:23-29``)."""
    get_model(model_name)
    trainer_module = importlib.import_module("recbole_cdr_tpu_torch.trainer")
    return getattr(trainer_module, f"{model_name}Trainer",
                   trainer_module.CrossDomainTrainer)
