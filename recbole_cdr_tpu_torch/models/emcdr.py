"""EMCDR — Embedding and Mapping for Cross-Domain Recommendation
(Man et al., IJCAI 2017).

Port of ``recbole_cdr_tpu/models/emcdr.py``. Three phases: SOURCE and
TARGET learn each domain's latent factors (MF, MSE on the pointwise stream
with ``loss_type: CE``, or BPR on the pairwise stream, plus EmbLoss);
OVERLAP learns a linear or tanh-MLP mapping from the source space to the
target space by MSE over the overlapped entities (the device loop's OVERLAP
stream). At inference the overlapped entities score through their mapped
source embedding. The MF dots of a step go through one call of kernel K1
(``ops/gather_dot.py``); ``full_sort_factors`` puts the mapped scoring on
the streaming evaluator for catalogs.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bpr_loss,
    emb_loss,
    mlp,
    weighted_mean,
    xavier_normal,
)
from recbole_cdr_tpu_torch.ops.gather_dot import gather_dot, gather_dot_forward


class EMCDR(CrossDomainRecommender):
    # no class-level input_type: the config derives it from loss_type
    # (CE -> POINTWISE; BPR -> PAIRWISE)

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mode = self._overlap_mode("EMCDR")
        self.phase = "both"

        self.latent_factor_model = config["latent_factor_model"]
        self.is_pairwise = self.latent_factor_model != "MF"
        self.source_latent_dim = config["source_embedding_size"]
        self.target_latent_dim = config["target_embedding_size"]
        self.reg_weight = float(config["reg_weight"])
        self.map_func = config["mapping_function"]
        self.mlp_hidden_size = config["mlp_hidden_size"]

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        Ds, Dt = self.source_latent_dim, self.target_latent_dim
        self._domain_tables(Ds, Dt, gen)
        if self.map_func == "linear":
            self.mapping = nn.Parameter(xavier_normal((Ds, Dt), gen))
        else:
            self.mapping = mlp([Ds] + list(self.mlp_hidden_size) + [Dt], gen)

    def trainable_predicate(self, phase: str):
        """Exactly the parameters the phase's loss reaches (torch's optimizers
        advance state only for parameters with a gradient)."""
        if phase == "SOURCE":
            live = {"source_user_embedding", "source_item_embedding"}
        elif phase == "TARGET":
            live = {"target_user_embedding", "target_item_embedding"}
        else:
            ent = "user" if self.mode == "overlap_users" else "item"
            live = {"mapping", f"source_{ent}_embedding", f"target_{ent}_embedding"}
        return lambda name: name in live

    def sparse_spec(self, phase: str):
        """Every phase reads the tables only through batch ids; OVERLAP's
        ``overlap`` key indexes two tables, at offset 0 of each."""
        if phase == "SOURCE":
            item_keys = [self.SOURCE_ITEM_ID]
            if self.is_pairwise:
                item_keys.append(self.SOURCE_NEG_ITEM_ID)
            return {"source_user_embedding": [self.SOURCE_USER_ID],
                    "source_item_embedding": item_keys}
        if phase == "TARGET":
            item_keys = [self.TARGET_ITEM_ID]
            if self.is_pairwise:
                item_keys.append(self.TARGET_NEG_ITEM_ID)
            return {"target_user_embedding": [self.TARGET_USER_ID],
                    "target_item_embedding": item_keys}
        ent = "user" if self.mode == "overlap_users" else "item"
        return {f"source_{ent}_embedding": ["overlap"],
                f"target_{ent}_embedding": ["overlap"]}

    # ------------------------------------------------------------------ parts

    def _map(self, x):
        if self.map_func == "linear":
            return x @ self.mapping
        # MLP with tanh between layers, none after the last (`emcdr.py:86-93`)
        for i, layer in enumerate(self.mapping):
            x = layer(x)
            if i != len(self.mapping) - 1:
                x = torch.tanh(x)
        return x

    def _tables(self, prefix):
        return (getattr(self, f"{prefix}_user_embedding"),
                getattr(self, f"{prefix}_item_embedding"))

    def _domain_loss(self, batch, prefix, uid_key, iid_key, neg_key, label_key, w_key):
        user_table, item_table = self._tables(prefix)
        w = batch[w_key]
        user = batch[uid_key].to(torch.int32)
        if not self.is_pairwise:
            pred = gather_dot(user_table, item_table, user, batch[iid_key].to(torch.int32))
            base = weighted_mean((pred - batch[label_key]) ** 2, w)  # MSE
        else:
            items = torch.cat([batch[iid_key], batch[neg_key]]).to(torch.int32)
            scores = gather_dot(user_table, item_table, torch.cat([user, user]), items)
            base = bpr_loss(scores[:user.shape[0]], scores[user.shape[0]:], w)
        reg = emb_loss([user_table[batch[uid_key].long()], item_table[batch[iid_key].long()]],
                       w)
        return base + self.reg_weight * reg

    # ----------------------------------------------------------------- losses

    def loss_fn(self, phase: str):
        if phase == "SOURCE":
            return lambda batch, rng=None: self._domain_loss(
                batch, "source", self.SOURCE_USER_ID, self.SOURCE_ITEM_ID,
                self.SOURCE_NEG_ITEM_ID, self.SOURCE_LABEL, "source_sample_weight")
        if phase == "OVERLAP":
            def loss(batch, rng=None):
                idx = batch["overlap"].long()
                ent = "user" if self.mode == "overlap_users" else "item"
                src_e = getattr(self, f"source_{ent}_embedding")[idx]
                tgt_e = getattr(self, f"target_{ent}_embedding")[idx]
                return weighted_mean(torch.mean((self._map(src_e) - tgt_e) ** 2, -1),
                                     batch["overlap_sample_weight"])
            return loss
        return lambda batch, rng=None: self._domain_loss(
            batch, "target", self.TARGET_USER_ID, self.TARGET_ITEM_ID,
            self.TARGET_NEG_ITEM_ID, self.TARGET_LABEL, "target_sample_weight")

    # ---------------------------------------------------------------- scoring

    def _mapped_user_e(self, user):
        mapped = self._map(self.source_user_embedding[user])
        direct = self.target_user_embedding[user]
        return torch.where((user < self.overlapped_num_users)[:, None], mapped, direct)

    def predict(self, batch):
        """Scores of the batch's pairs in the current phase (``predict_fn``,
        `emcdr.py:194-219`); the per-domain phases through K1's forward."""
        if self.phase in ("SOURCE", "TARGET"):
            prefix = self.phase.lower()
            key = self.SOURCE_USER_ID if prefix == "source" else self.TARGET_USER_ID
            ikey = self.SOURCE_ITEM_ID if prefix == "source" else self.TARGET_ITEM_ID
            return gather_dot_forward(*self._tables(prefix), batch[key].to(torch.int32),
                                      batch[ikey].to(torch.int32))
        user = batch[self.TARGET_USER_ID].long()
        item = batch[self.TARGET_ITEM_ID].long()
        if self.mode == "overlap_users":
            user_e = self._mapped_user_e(user)
            item_e = self.target_item_embedding[item]
        else:
            user_e = self.target_user_embedding[user]
            mapped = self._map(self.source_item_embedding[item])
            direct = self.target_item_embedding[item]
            item_e = torch.where((item < self.overlapped_num_items)[:, None], mapped, direct)
        return torch.sum(user_e * item_e, -1)

    def full_sort(self, users, phase: str = "TARGET"):
        user_e, item_e = self.full_sort_factors(phase)(users)
        return torch.matmul(user_e, item_e.T)

    def full_sort_factors(self, phase: str = "TARGET"):
        """``users -> (user representation, item table)``: the full-sort
        score is their product (`emcdr.py:262-303`)."""
        if phase == "SOURCE":
            return lambda users: (
                self.source_user_embedding[users],
                torch.cat([self.source_item_embedding[:self.overlapped_num_items],
                           self.source_item_embedding[self.target_num_items:]], 0))
        if phase == "TARGET":
            return lambda users: (self.target_user_embedding[users],
                                  self.target_item_embedding[:self.target_num_items])

        def factors(users):
            if self.mode == "overlap_users":
                return (self._mapped_user_e(users),
                        self.target_item_embedding[:self.target_num_items])
            overlap_item_e = self._map(self.source_item_embedding[:self.overlapped_num_items])
            target_item_e = self.target_item_embedding[
                self.overlapped_num_items:self.target_num_items]
            return (self.target_user_embedding[users],
                    torch.cat([overlap_item_e, target_item_e], 0))
        return factors
