"""Parameter conversion from the JAX package's pytrees.

A JAX model's parameters are a dict of arrays whose keys are the port
module's parameter names (``user_embedding``, ``item_embedding`` for CMF);
nested dicts become dotted names (NATR's ``{"transfer": {"w", "b"}}`` is the
port's ``transfer.w`` and ``transfer.b``), so the JAX and torch versions of
a model can run from one set of weights.
"""

import numpy as np
import torch


def params_from_jax(tree, prefix: str = "") -> dict:
    """state_dict for the port's module from a (nested) dict of numpy
    arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(params_from_jax(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v, copy=True))
    return out
