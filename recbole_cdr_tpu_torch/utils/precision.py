"""Mixed-precision policy: 16-bit compute over float32 master parameters.

Port of ``recbole_cdr_tpu/utils/precision.py``. Parameters and optimizer
state stay float32; with ``compute_dtype: bfloat16`` (or float16) the
trainer runs every loss, predict, full-sort and factors function on 16-bit
copies of the model's floating parameters and buffers, so gathers and
products move half the bytes, while gradients flow back through the cast
into the float32 masters (the JAX cast's VJP). Loss reductions accumulate in
float32 (``models/base.py::weighted_mean`` and the other loss helpers
upcast).
"""

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve_compute_dtype(config) -> torch.dtype:
    name = str(config["compute_dtype"] or "float32").lower()
    if name not in _DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}"
        )
    return _DTYPES[name]


def cast_floats(tensors: dict, dtype) -> dict:
    """Cast every floating tensor of a name -> tensor dict to ``dtype``
    (integer and bool tensors pass through untouched: ids, masks and
    histories must stay integral). The cast is differentiable."""
    return {n: t.to(dtype) if t.is_floating_point() else t for n, t in tensors.items()}


class _Call(nn.Module):
    """Holds ``model`` so that ``torch.func.functional_call`` can substitute
    its tensors around any function of it, not only its ``forward``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, args, kwargs):
        return fn(*args, **kwargs)


def call_with(model: nn.Module, tensors: dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the named parameters and buffers of
    ``model`` in ``tensors`` standing in for the module's own."""
    return torch.func.functional_call(
        _Call(model), {"model." + n: t for n, t in tensors.items()}, (fn, args, kwargs))


def with_compute_dtype(fn, dtype, model: nn.Module):
    """Wrap ``fn`` (a function of ``model``'s tensors) to run on ``dtype``
    copies of the model's floating parameters and buffers, as they stand at
    the call (a substitution already in force, such as the sparse step's
    gathered sub-tables, is what gets cast). Identity for float32. Routing
    flags of ``fn`` survive the wrap."""
    if fn is None or dtype == torch.float32:
        return fn

    def wrapped(*args, **kwargs):
        tensors = dict(model.named_parameters())
        tensors.update(model.named_buffers())
        return call_with(model, cast_floats(tensors, dtype), fn, *args, **kwargs)

    # evaluator routing hints must survive the wrap
    if getattr(fn, "_pair_cost", False):
        wrapped._pair_cost = True
    return wrapped

