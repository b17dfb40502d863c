"""CMF — Collective Matrix Factorization (Singh & Gordon, SIGKDD 2008).

Port of ``recbole_cdr_tpu/models/cmf.py``: one shared user table + one shared
item table over the unified ID space, jointly factorizing both domains'
interaction matrices with a BCE objective
``alpha * loss_source + (1 - alpha) * loss_target`` plus per-domain EmbLoss.

The pair scores of a step go through one call of kernel K1
(``ops/gather_dot.py``) for both domains; full-sort scoring is one
``[B, D] @ [D, target_num_items]`` matmul against the contiguous target
prefix of the item table, whose two factors ``full_sort_factors`` also hands
to the streaming evaluator.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bce_loss,
    emb_loss,
    init_embedding,
)
from recbole_cdr_tpu_torch.ops.gather_dot import gather_dot
from recbole_cdr_tpu_torch.utils.enums import InputType


class CMF(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.alpha = float(config["alpha"])
        self.lamda = float(config["lambda"])
        self.gamma = float(config["gamma"])
        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        self.user_embedding = nn.Parameter(
            init_embedding(self.total_num_users, self.embedding_size, gen))
        self.item_embedding = nn.Parameter(
            init_embedding(self.total_num_items, self.embedding_size, gen))

    def _score(self, user, item):
        return gather_dot(self.user_embedding, self.item_embedding, user, item)  # logits

    def _domain_loss(self, logits, user, item, label, weight, coef):
        loss = bce_loss(logits, label, weight)
        if coef:  # a zero coefficient adds exactly 0 to the loss and its grads
            loss = loss + coef * emb_loss(
                [self.user_embedding[user.long()], self.item_embedding[item.long()]], weight
            )
        return loss

    def loss(self, batch, rng=None):
        su, si = batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]
        tu, ti = batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]
        # both domains' pairs in one kernel call
        logits = self._score(torch.cat([su, tu]), torch.cat([si, ti]))
        ls, lt = logits[:su.shape[0]], logits[su.shape[0]:]
        loss_s = self._domain_loss(ls, su, si, batch[self.SOURCE_LABEL],
                                   batch["source_sample_weight"], self.lamda)
        loss_t = self._domain_loss(lt, tu, ti, batch[self.TARGET_LABEL],
                                   batch["target_sample_weight"], self.gamma)
        return loss_s * self.alpha + loss_t * (1.0 - self.alpha)

    def loss_fn(self, phase: str):
        return self.loss

    def sparse_spec(self, phase: str):
        """Both tables are read only through batch ids (scores + EmbLoss on
        the gathered rows), so every phase supports the row-sparse
        optimizer."""
        return {
            "user_embedding": [self.SOURCE_USER_ID, self.TARGET_USER_ID],
            "item_embedding": [self.SOURCE_ITEM_ID, self.TARGET_ITEM_ID],
        }

    def predict(self, batch):
        """Target probabilities of the pairs of ``batch`` through K1's
        forward (``predict_fn``, `models/cmf.py:80-86`)."""
        return torch.sigmoid(self._score(batch[self.TARGET_USER_ID].to(torch.int32),
                                         batch[self.TARGET_ITEM_ID].to(torch.int32)))

    def full_sort(self, users, phase: str = "TARGET"):
        user_e, item_e = self.full_sort_factors(phase)(users)
        return torch.matmul(user_e, item_e.T)

    def full_sort_factors(self, phase: str = "TARGET"):
        return lambda users: (self.user_embedding[users],
                              self.item_embedding[:self.target_num_items])
