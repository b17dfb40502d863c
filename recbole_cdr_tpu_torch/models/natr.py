"""NATR — cross-domain recommendation without sharing user-relevant data
(Gao et al., WWW 2019).

Port of ``recbole_cdr_tpu/models/natr.py``. Phase 1 (SOURCE): plain MF on
the source domain, its pair scores through kernel K1
(``ops/gather_dot.py``). Phase 2 (TARGET): the source tables freeze; a
target score attends over the anchor's history of source embeddings
(item-level attention, then a domain-level gate blending the attended source
representation with the target embedding), through kernel B9
(``ops/natr_attention.py``). The anchor is the user when the pair overlaps
on items and the item when it overlaps on users; histories come from the
whole target domain, evaluation interactions included (as the JAX package
builds them), truncated to ``max_inter_length``.

In the TARGET phase B9 receives the source table detached: the phase freezes
it, and where JAX computes its gradient and the optimizer mask discards it,
the port computes none.

Full-sort scoring exists for the SOURCE phase only (the overlap prefix and
the source-only suffix of the source item table, one matmul); every other
phase scores through :meth:`predict_grid`, which the trainer's predict
fallback calls: B9's anchor table computes every anchor's attention once
per parameter version (so once per evaluation pass), and B9's pair grid the
blend once per pair of each tile.
"""

import numpy as np
import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    Linear,
    bce_loss,
    init_embedding,
    reg_loss,
)
from recbole_cdr_tpu_torch.ops.gather_dot import gather_dot
from recbole_cdr_tpu_torch.ops.natr_attention import (
    History,
    Weights,
    natr_anchor_table,
    natr_attention,
    natr_pair_grid,
)
from recbole_cdr_tpu_torch.utils.enums import InputType
from recbole_cdr_tpu_torch.utils.precision import require_float32_compute


class NATR(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        require_float32_compute(config, "NATR (kernel B9)")
        assert self.overlapped_num_items == 1 or self.overlapped_num_users == 1, (
            "NATR model only support user overlapped or item overlapped dataset! "
        )
        if self.overlapped_num_users > 1:
            self.mode = "overlap_users"
        elif self.overlapped_num_items > 1:
            self.mode = "overlap_items"
        else:
            self.mode = "non_overlap"

        self.source_embedding_size = config["source_embedding_size"]
        self.target_embedding_size = config["target_embedding_size"]
        self.reg_weight = float(config["reg_weight"])
        self.max_inter_length = config["max_inter_length"]

        if self.mode == "overlap_users":
            hist, _, lens = dataset.history_user_matrix(domain="target")
        else:
            hist, _, lens = dataset.history_item_matrix(domain="target")
        hist = hist[:, : self.max_inter_length]
        lens = np.minimum(lens, hist.shape[1])
        # buffers: moved by .to(), kept out of the state dict
        self.register_buffer("history", torch.as_tensor(hist.astype(np.int32)),
                             persistent=False)
        self.register_buffer(
            "hist_mask", torch.as_tensor(np.arange(hist.shape[1])[None, :] < lens[:, None]),
            persistent=False)

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        Ds, Dt = self.source_embedding_size, self.target_embedding_size
        self.source_user_embedding = nn.Parameter(init_embedding(self.total_num_users, Ds, gen))
        self.source_item_embedding = nn.Parameter(init_embedding(self.total_num_items, Ds, gen))
        self.target_user_embedding = nn.Parameter(init_embedding(self.total_num_users, Dt, gen))
        self.target_item_embedding = nn.Parameter(init_embedding(self.total_num_items, Dt, gen))
        self.transfer = Linear(Ds, Dt, gen)
        self.unit_attention = Linear(Dt, 1, gen)
        self.domain_attention = Linear(Dt, 1, gen)

    def trainable_predicate(self, phase):
        """The parameters the phase's loss reaches."""
        source = {"source_user_embedding", "source_item_embedding"}
        if phase == "TARGET":
            return lambda name: name not in source
        return lambda name: name in source

    def sparse_spec(self, phase):
        """Only the SOURCE MF phase touches tables purely through batch ids;
        TARGET's RegLoss reads the whole tables, so it keeps the dense
        optimizer."""
        if phase == "SOURCE":
            return {"source_user_embedding": [self.SOURCE_USER_ID],
                    "source_item_embedding": [self.SOURCE_ITEM_ID]}
        return None

    # ----------------------------------------------------------------- parts

    def _weights(self):
        return Weights(self.transfer.w, self.transfer.b, self.unit_attention.w,
                       self.unit_attention.b, self.domain_attention.w, self.domain_attention.b)

    def _history(self):
        """The anchors' history over the detached source table."""
        table = (self.source_item_embedding if self.mode == "overlap_items"
                 else self.source_user_embedding)
        return History(table.detach(), self.history, self.hist_mask)

    def _phase1_logit(self, user, item):
        return gather_dot(self.source_user_embedding, self.source_item_embedding, user, item)

    def _phase2_logit(self, user, item):
        user_e = self.target_user_embedding[user.long()]
        item_e = self.target_item_embedding[item.long()]
        if self.mode == "overlap_items":
            anchors, pu, qi = user, user_e, item_e
        else:
            anchors, pu, qi = item, item_e, user_e
        return natr_attention(self._history(), anchors.to(torch.int32), pu, qi, self._weights())

    # ----------------------------------------------------------------- losses

    def loss_fn(self, phase: str):
        if phase == "SOURCE":
            def loss(batch, rng=None):
                logit = self._phase1_logit(batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID])
                return bce_loss(logit, batch[self.SOURCE_LABEL], batch["source_sample_weight"])
            return loss

        def loss(batch, rng=None):
            logit = self._phase2_logit(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID])
            rec = bce_loss(logit, batch[self.TARGET_LABEL], batch["target_sample_weight"])
            reg = reg_loss([self.target_user_embedding, self.target_item_embedding,
                            self.transfer.w, self.unit_attention.w, self.domain_attention.w])
            return rec + self.reg_weight * reg
        return loss

    # ---------------------------------------------------------------- scoring

    def predict(self, batch):
        if self.phase == "SOURCE":
            return torch.sigmoid(
                self._phase1_logit(batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]))
        return torch.sigmoid(
            self._phase2_logit(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]))

    def _anchor_table(self):
        """``su`` of every anchor row of the target domain (every target user
        in overlap_items mode, every target item otherwise), built by one
        launch of B9's anchor table per parameter version (``params_version``,
        bumped by the training step and by ``load_state_dict``), so an
        evaluation pass builds it once and its tiles gather from it. Training
        never reads it."""
        def build():
            if self.mode == "overlap_items":
                n, table = self.target_num_users, self.target_user_embedding
            else:
                n, table = self.target_num_items, self.target_item_embedding
            with torch.no_grad():
                anchors = torch.arange(n, dtype=torch.int32, device=table.device)
                return natr_anchor_table(self._history(), anchors, table[:n], self._weights())
        return self._per_version("anchor_table", build)

    def predict_grid(self, users, items):
        """Probabilities of the target pairs ``users [B]`` x ``items [I]``:
        the anchors' ``su`` gathered from the pass's anchor table, then one
        launch of B9's pair grid (the blend per pair)."""
        su_all = self._anchor_table()
        user_e = self.target_user_embedding[users.long()]
        item_e = self.target_item_embedding[items.long()]
        if self.mode == "overlap_items":
            return natr_pair_grid(su_all[users.long()], user_e, item_e, self._weights(),
                                  anchor_is_row=True)
        return natr_pair_grid(su_all[items.long()], item_e, user_e, self._weights(),
                              anchor_is_row=False)

    def full_sort(self, users, phase: str = "TARGET"):
        if phase != "SOURCE":
            raise ValueError(f"NATR has no full-sort form in phase {phase}; "
                             "it scores through predict_grid (full_sort_fn is None)")
        user_e = self.source_user_embedding[users.long()]
        all_item_e = torch.cat([self.source_item_embedding[:self.overlapped_num_items],
                                self.source_item_embedding[self.target_num_items:]])
        return torch.matmul(user_e, all_item_e.T)

    def full_sort_fn(self, phase: str = "TARGET"):
        """SOURCE only; the other phases score through the predict fallback."""
        return super().full_sort_fn(phase) if phase == "SOURCE" else None
