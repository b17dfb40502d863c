"""DeepAPF — Deep Attentive Probabilistic Factorization (Yan et al., IJCAI 2019).

Port of ``recbole_cdr_tpu/models/deepapf.py``: three embedding tables per
side (source, target, shared); an attention MLP softmax-weights the shared
and the domain-specific row of the pair's entity, the shared branch masked
to -1e31 for entities that do not overlap (the reference's strict ``id >
overlapped_num``), and the blend is dotted with the other side's row
through ``predict_layer``. Joint BCE loss over both domains. ``beta`` is
loaded by the reference and used nowhere; so here.

Every pair's logit goes through kernel B16 (``ops/deepapf_attention.py``):
one forward and one backward launch per training step, both domains' pairs
in one call; the gathers of the pairs' rows stay torch's, so their
gradients scatter into the tables through the gathers' own autograd.

No full-sort form, as in JAX: the trainer scores full-sort evaluation
through :meth:`predict_grid`, the predict fallback, which scores a whole
tile in one launch of B16's grid form (the rows read from the tables by
id, no [B I, D] pair tensor).

Under ``compute_dtype: bfloat16`` (or float16) the trainer hands every call
16-bit copies of the tables and weights, so the pairs and the grid reach
B16's 16-bit forms (``deepapf_*_bf16``): 16-bit logits and probabilities.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    Linear,
    bce_loss,
    init_embedding,
    xavier_normal,
)
from recbole_cdr_tpu_torch.ops.deepapf_attention import Weights, deepapf_attention, deepapf_grid
from recbole_cdr_tpu_torch.utils.enums import InputType


class _Head(nn.Module):
    """The attention MLP's second layer, ``x @ w`` with ``w`` [D, 1] and no
    bias (JAX's ``{"w": [D, 1]}``)."""

    def __init__(self, d_in, generator=None):
        super().__init__()
        self.w = nn.Parameter(xavier_normal((d_in, 1), generator))


class DeepAPF(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        assert self.overlapped_num_items == 1 or self.overlapped_num_users == 1, (
            "DeepAPF model only support user overlapped or item overlapped dataset! "
        )
        if self.overlapped_num_users > 1:
            self.mode = "overlap_users"
        elif self.overlapped_num_items > 1:
            self.mode = "overlap_items"
        else:
            self.mode = "non_overlap"
        self.embedding_size = config["embedding_size"]

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        D = self.embedding_size
        for side, n in (("user", self.total_num_users), ("item", self.total_num_items)):
            for prefix in ("source", "target", "share"):
                setattr(self, f"{prefix}_{side}_embedding", nn.Parameter(init_embedding(n, D, gen)))
        self.user_mlp = nn.ModuleList([Linear(D, D, gen), _Head(D, gen)])
        self.item_mlp = nn.ModuleList([Linear(D, D, gen), _Head(D, gen)])
        self.predict_layer = nn.Parameter(xavier_normal((D, 1), gen))

    @property
    def _entity(self) -> str:
        """The side whose shared and domain rows the attention blends: the
        users in overlap_users mode, else the items (non_overlap too)."""
        return "user" if self.mode == "overlap_users" else "item"

    def trainable_predicate(self, phase):
        """The other side's share table and attention MLP never reach the
        loss (`deepapf.py:57-68`): the optimizer must never tick them."""
        other = "item" if self._entity == "user" else "user"
        dead = {f"share_{other}_embedding", f"{other}_mlp"}
        return lambda name: name not in dead

    def _weights(self) -> Weights:
        mlp = getattr(self, f"{self._entity}_mlp")
        return Weights(mlp[0].w, mlp[0].b, mlp[1].w, self.predict_layer)

    def _rows(self, user, item, domain: str):
        """(share, only, other rows, mask) of the pairs (user, item) of
        ``domain``."""
        user, item = user.long(), item.long()
        if self._entity == "user":
            ent, oth, n_ov = user, item, self.overlapped_num_users
            other = getattr(self, f"{domain}_item_embedding")[oth]
        else:
            ent, oth, n_ov = item, user, self.overlapped_num_items
            other = getattr(self, f"{domain}_user_embedding")[oth]
        side = self._entity
        share = getattr(self, f"share_{side}_embedding")[ent]
        only = getattr(self, f"{domain}_{side}_embedding")[ent]
        return share, only, other, ent > n_ov  # strict >, as the reference's

    def loss(self, batch, rng=None):
        """Both domains' pairs through one B16 call."""
        s = self._rows(batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID], "source")
        t = self._rows(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID], "target")
        logits = deepapf_attention(*(torch.cat(pair) for pair in zip(s, t)), self._weights())
        n = s[0].shape[0]
        return (bce_loss(logits[:n], batch[self.SOURCE_LABEL], batch["source_sample_weight"])
                + bce_loss(logits[n:], batch[self.TARGET_LABEL], batch["target_sample_weight"]))

    def loss_fn(self, phase: str):
        return self.loss

    def predict(self, batch):
        rows = self._rows(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID], "target")
        return torch.sigmoid(deepapf_attention(*rows, self._weights()))

    def predict_grid(self, users, items):
        """Probabilities of the target pairs ``users [B]`` x ``items [I]`` in
        one launch of B16's grid form."""
        side = self._entity
        other = "item" if side == "user" else "user"
        n_ov = self.overlapped_num_users if side == "user" else self.overlapped_num_items
        return deepapf_grid(getattr(self, f"share_{side}_embedding"),
                            getattr(self, f"target_{side}_embedding"),
                            getattr(self, f"target_{other}_embedding"),
                            users, items, n_ov, side == "item", self._weights())

    def full_sort_fn(self, phase: str = "TARGET"):
        """None: the trainer scores through the predict fallback."""
        return None
