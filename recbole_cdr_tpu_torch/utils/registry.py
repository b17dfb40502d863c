"""Model / trainer registries.

Capability parity with ``get_model`` / ``get_trainer``
(`recbole_cdr/utils/utils.py:16-59`) for the models this package has ported:
CMF, BiTGCF, NATR and DTCDR, with the generic :class:`CrossDomainTrainer`. The other models of the JAX
package are queued in ROADMAP.md (item A8) and raise here.
"""

import importlib

#: model name -> module under ``recbole_cdr_tpu_torch.models``
_PORTED = {"CMF": "cmf", "BiTGCF": "bitgcf", "NATR": "natr", "DTCDR": "dtcdr"}

#: models of the reference that are still to be ported (ROADMAP.md A8)
_QUEUED = ("EMCDR", "CLFM", "CoNet", "DeepAPF", "SSCDR", "DCDCSR")


def get_model(model_name: str):
    """Resolve a model name (e.g. ``"CMF"``) to its model class."""
    if model_name in _QUEUED:
        raise NotImplementedError(
            f"Model [{model_name}] is not ported to PyTorch yet (ROADMAP.md A8)"
        )
    if model_name not in _PORTED:
        raise ValueError(f"Model [{model_name}] not found")
    module = importlib.import_module(
        f"recbole_cdr_tpu_torch.models.{_PORTED[model_name]}"
    )
    return getattr(module, model_name)


def get_trainer(model_type, model_name: str):
    """Resolve the trainer class for a model: every ported model trains with
    the generic :class:`CrossDomainTrainer`."""
    get_model(model_name)
    from recbole_cdr_tpu_torch.trainer import CrossDomainTrainer

    return CrossDomainTrainer
