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

Under a (data, model) mesh (``mesh_shape``, ``parallel/mesh.py``) the loss
takes its batch sums over the whole global batch (each rank trains on its
``data`` slice), and when the ``model`` axis is wider than one the two
tables are row-sharded: a step's rows come through the row-sharded lookup
(``parallel/embedding.py``) and K1 scores the gathered rows; the streaming
factors are this rank's rows of the target prefix at their global offset,
so no rank holds the whole item table, and the dense full-sort form scores
against the table gathered over the model group.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bce_terms,
    domain_loss,
    domain_sums,
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

    #: trains and evaluates under ``mesh_shape``
    MESH_READY = True

    def _pairs(self, user, item):
        """K1's operands for the pairs (user, item) (``pair_rows``)."""
        return self.pair_rows("user_embedding", "item_embedding", user, item)

    def _score(self, user, item):
        return gather_dot(*self._pairs(user, item))  # logits

    def loss(self, batch, rng=None):
        su, si = batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]
        tu, ti = batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]
        n = su.shape[0]
        # both domains' pairs in one kernel call
        U, I, u, i, positions = self._pairs(torch.cat([su, tu]), torch.cat([si, ti]))
        logits = gather_dot(U, I, u, i, positions)
        # EmbLoss's norms only where its coefficient is not 0 (they would add
        # exactly 0 to the loss and its grads)
        rows = lambda part, coef: [U[u[part].long()], I[i[part].long()]] if coef else None
        sums_s = domain_sums(bce_terms(logits[:n], batch[self.SOURCE_LABEL]),
                             batch["source_sample_weight"], rows(slice(0, n), self.lamda))
        sums_t = domain_sums(bce_terms(logits[n:], batch[self.TARGET_LABEL]),
                             batch["target_sample_weight"], rows(slice(n, None), self.gamma))
        sums = self.batch_sums(*sums_s, *sums_t)  # one reduction for both domains
        loss_s = domain_loss(sums[:len(sums_s)], self.lamda)
        loss_t = domain_loss(sums[len(sums_s):], self.gamma)
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
        items = self.whole_items(("item_embedding", self.target_num_items))
        return torch.matmul(self.rows("user_embedding", users), items.T)

    def full_sort_factors(self, phase: str = "TARGET"):
        """``users -> (user rows, the target item prefix)``; under a mesh
        ``(user rows, this rank's rows of the prefix, their first global
        row)``."""
        return lambda users: self.item_factors(self.rows("user_embedding", users),
                                               ("item_embedding", self.target_num_items))
