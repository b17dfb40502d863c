"""Parameter conversion from the JAX package's pytrees.

A JAX model's parameters are a dict of arrays whose keys are the port
module's parameter names (``user_embedding``, ``item_embedding`` for CMF);
nested dicts become dotted names (NATR's ``{"transfer": {"w", "b"}}`` is the
port's ``transfer.w`` and ``transfer.b``) and lists take their positions
(DTCDR's ``{"source_mlp": [{"w", "b"}, ...]}`` is ``source_mlp.0.w``, ...,
the names of an ``nn.ModuleList``), so the JAX and torch versions of a model
can run from one set of weights. Entries the port keeps as buffers, not
parameters (DCDCSR's ``benchmark_embedding`` and ``affine_embedding``),
convert the same way, at whatever shape the JAX tree holds them:
``CrossDomainRecommender.load_state_dict`` takes a buffer at the state
dict's shape.
"""

import numpy as np
import torch


def params_from_jax(tree, prefix: str = "") -> dict:
    """state_dict for the port's module from a (nested) dict or list of
    numpy arrays."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(params_from_jax(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, copy=True))
    return out
