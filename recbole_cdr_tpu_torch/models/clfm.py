"""CLFM — Cluster-Level Latent Factor Model (Gao et al., PKDD 2013).

Port of ``recbole_cdr_tpu/models/clfm.py``: per-domain user and item
tables; each domain's user row is projected through a shared linear map
(width ``share_embedding_size``) and a domain-private one, the two
projections concatenated and dotted with the item row. BCE objective
``alpha * source + (1 - alpha) * target`` with ``reg_weight`` EmbLoss.

The pair score is a dot of a projected user row with an item row, so it is
torch's elementwise product and sum, not kernel K1 (which dots two table
rows); the projection ``user_e @ linear`` is a plain matrix product, as the
JAX package leaves it to XLA. Full-sort scoring is one ``[B, d] @ [d,
target_num_items]`` product against the contiguous target prefix of the
target item table, whose two factors ``full_sort_factors`` also hands to
the streaming evaluator (kernel B5, or B13 on 16-bit factors).

The reference's quirk is kept: the target item width reads
``source_item_embedding_size``.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bce_loss,
    emb_loss,
    init_embedding,
    xavier_normal,
)
from recbole_cdr_tpu_torch.utils.enums import InputType


class CLFM(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.user_embedding_size = config["user_embedding_size"]
        # reference quirk kept for parity: the target width also reads
        # source_item_embedding_size (`clfm.py:38`)
        self.source_item_embedding_size = config["source_item_embedding_size"]
        self.target_item_embedding_size = config["source_item_embedding_size"]
        self.share_embedding_size = config["share_embedding_size"]
        self.alpha = float(config["alpha"])
        self.reg_weight = float(config["reg_weight"])
        assert 0 <= self.share_embedding_size <= self.source_item_embedding_size
        assert 0 <= self.share_embedding_size <= self.target_item_embedding_size

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        d_u, share = self.user_embedding_size, self.share_embedding_size
        self.source_user_embedding = nn.Parameter(init_embedding(self.total_num_users, d_u, gen))
        self.target_user_embedding = nn.Parameter(init_embedding(self.total_num_users, d_u, gen))
        self.source_item_embedding = nn.Parameter(
            init_embedding(self.total_num_items, self.source_item_embedding_size, gen))
        self.target_item_embedding = nn.Parameter(
            init_embedding(self.total_num_items, self.target_item_embedding_size, gen))
        # each map exists only where its width is positive (`clfm.py:52-62`)
        if share > 0:
            self.shared_linear = nn.Parameter(xavier_normal((d_u, share), gen))
        for domain, width in (("source", self.source_item_embedding_size),
                              ("target", self.target_item_embedding_size)):
            if width - share > 0:
                setattr(self, f"{domain}_only_linear",
                        nn.Parameter(xavier_normal((d_u, width - share), gen)))

    def _factors(self, user_e, domain: str):
        """The user rows projected through the shared and the domain's own
        map, concatenated."""
        parts = []
        if self.share_embedding_size > 0:
            parts.append(torch.matmul(user_e, self.shared_linear))
        only = getattr(self, f"{domain}_only_linear", None)
        if only is not None:
            parts.append(torch.matmul(user_e, only))
        return torch.cat(parts, -1)

    def _forward(self, user, item, domain: str):
        user_e = nn.functional.embedding(user.long(), getattr(self, f"{domain}_user_embedding"))
        item_e = nn.functional.embedding(item.long(), getattr(self, f"{domain}_item_embedding"))
        return (self._factors(user_e, domain) * item_e).sum(-1)  # logits

    def _domain_loss(self, batch, domain: str, uid: str, iid: str, label: str):
        user, item = batch[uid].long(), batch[iid].long()
        weight = batch[f"{domain}_sample_weight"]
        rows = [nn.functional.embedding(user, getattr(self, f"{domain}_user_embedding")),
                nn.functional.embedding(item, getattr(self, f"{domain}_item_embedding"))]
        return (bce_loss(self._forward(user, item, domain), batch[label], weight)
                + self.reg_weight * emb_loss(rows, weight))

    def loss(self, batch, rng=None):
        loss_s = self._domain_loss(batch, "source", self.SOURCE_USER_ID, self.SOURCE_ITEM_ID,
                                   self.SOURCE_LABEL)
        loss_t = self._domain_loss(batch, "target", self.TARGET_USER_ID, self.TARGET_ITEM_ID,
                                   self.TARGET_LABEL)
        return loss_s * self.alpha + loss_t * (1.0 - self.alpha)

    def loss_fn(self, phase: str):
        return self.loss

    def predict(self, batch):
        return torch.sigmoid(self._forward(batch[self.TARGET_USER_ID],
                                           batch[self.TARGET_ITEM_ID], "target"))

    def full_sort(self, users, phase: str = "TARGET"):
        factors, items = self.full_sort_factors(phase)(users)
        return torch.matmul(factors, items.T)

    def full_sort_factors(self, phase: str = "TARGET"):
        """``users -> (the users' projected rows, the target item prefix)``:
        the dot-product form of full-sort scoring (`clfm.py:126-137`)."""
        def factors(users):
            user_e = self.target_user_embedding[users.long()]
            return (self._factors(user_e, "target"),
                    self.target_item_embedding[:self.target_num_items])
        return factors
