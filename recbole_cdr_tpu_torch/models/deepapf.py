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
in one call, which takes the five live tables and the pairs' ids (no gather
and no concatenation of rows): the kernels read each row by id, and the
backward writes the tables' gradients itself, each row summed in a fixed
order from the plan of the step's ids.

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
from recbole_cdr_tpu_torch.ops.deepapf_attention import (
    Pairs,
    Tables,
    Weights,
    deepapf_attention,
    deepapf_grid,
)
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

    @property
    def _overlapped(self) -> int:
        return self.overlapped_num_users if self._entity == "user" else self.overlapped_num_items

    def _tables(self, source: str = "source") -> Tables:
        """The entity side's shared table, then each domain's entity and
        other-side tables (``source``'s in the source slots: "target" for a
        call of target pairs alone)."""
        side = self._entity
        other = "item" if side == "user" else "user"
        return Tables(getattr(self, f"share_{side}_embedding"),
                      getattr(self, f"{source}_{side}_embedding"),
                      getattr(self, f"target_{side}_embedding"),
                      getattr(self, f"{source}_{other}_embedding"),
                      getattr(self, f"target_{other}_embedding"))

    def _ids(self, user, item):
        """(entity ids, other ids) of the pairs (user, item), int32."""
        user, item = user.to(torch.int32), item.to(torch.int32)
        return (user, item) if self._entity == "user" else (item, user)

    def loss(self, batch, rng=None):
        """Both domains' pairs through one B16 call."""
        pairs = Pairs(*self._ids(batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]),
                      *self._ids(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]))
        logits = deepapf_attention(self._tables(), pairs, self._overlapped, self._weights())
        n = pairs.ent_src.shape[0]
        return (bce_loss(logits[:n], batch[self.SOURCE_LABEL], batch["source_sample_weight"])
                + bce_loss(logits[n:], batch[self.TARGET_LABEL], batch["target_sample_weight"]))

    def loss_fn(self, phase: str):
        return self.loss

    def predict(self, batch):
        ent, oth = self._ids(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID])
        pairs = Pairs(ent[:0], oth[:0], ent, oth)
        return torch.sigmoid(deepapf_attention(self._tables("target"), pairs, self._overlapped,
                                               self._weights()))

    def predict_grid(self, users, items):
        """Probabilities of the target pairs ``users [B]`` x ``items [I]`` in
        one launch of B16's grid form."""
        tabs = self._tables("target")
        return deepapf_grid(tabs.share, tabs.only_tgt, tabs.other_tgt, users, items,
                            self._overlapped, self._entity == "item", self._weights())

    def full_sort_fn(self, phase: str = "TARGET"):
        """None: the trainer scores through the predict fallback."""
        return None
