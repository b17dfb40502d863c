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

Under a (data, model) mesh (``MESH_READY``) every read of a table goes
through ``rows`` and every batch sum through ``batch_sums``, the OVERLAP
mapping loss's too, and the mapping MLP's gradients are summed over the
data group by the trainer. The SOURCE phase's item block joins two disjoint
ranges of the source item table (the overlapped prefix and the source-only
suffix), and the OVERLAP phase's item block of the item-overlap mode maps
the overlapped prefix: neither has one column offset on a row shard, so
each is built from the tables gathered over the model group (``full_table``)
and every model rank scores its contiguous share of it (``item_factors``).
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bpr_terms,
    domain_loss,
    domain_sums,
    mlp,
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

    #: trains and evaluates under ``mesh_shape``
    MESH_READY = True

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

    @staticmethod
    def _names(prefix):
        return f"{prefix}_user_embedding", f"{prefix}_item_embedding"

    def _domain_loss(self, batch, prefix, uid_key, iid_key, neg_key, label_key, w_key):
        user, n = batch[uid_key], batch[uid_key].shape[0]
        if not self.is_pairwise:
            U, I, u, i, positions = self.pair_rows(*self._names(prefix), user, batch[iid_key])
            terms = (gather_dot(U, I, u, i, positions) - batch[label_key]) ** 2  # MSE
        else:
            U, I, u, i, positions = self.pair_rows(*self._names(prefix), torch.cat([user, user]),
                                                   torch.cat([batch[iid_key], batch[neg_key]]))
            scores = gather_dot(U, I, u, i, positions)
            terms = bpr_terms(scores[:n], scores[n:])
        # the loss's and EmbLoss's batch sums in one reduction
        sums = self.batch_sums(*domain_sums(terms, batch[w_key],
                                            [U[u[:n].long()], I[i[:n].long()]]))
        return domain_loss(sums, self.reg_weight)

    # ----------------------------------------------------------------- losses

    def loss_fn(self, phase: str):
        if phase == "SOURCE":
            return lambda batch, rng=None: self._domain_loss(
                batch, "source", self.SOURCE_USER_ID, self.SOURCE_ITEM_ID,
                self.SOURCE_NEG_ITEM_ID, self.SOURCE_LABEL, "source_sample_weight")
        if phase == "OVERLAP":
            def loss(batch, rng=None):
                idx = batch["overlap"]
                ent = "user" if self.mode == "overlap_users" else "item"
                src_e = self.rows(f"source_{ent}_embedding", idx)
                tgt_e = self.rows(f"target_{ent}_embedding", idx)
                return self.batch_mean(torch.mean((self._map(src_e) - tgt_e) ** 2, -1),
                                       batch["overlap_sample_weight"])
            return loss
        return lambda batch, rng=None: self._domain_loss(
            batch, "target", self.TARGET_USER_ID, self.TARGET_ITEM_ID,
            self.TARGET_NEG_ITEM_ID, self.TARGET_LABEL, "target_sample_weight")

    # ---------------------------------------------------------------- scoring

    def _mapped_user_e(self, user):
        mapped = self._map(self.rows("source_user_embedding", user))
        direct = self.rows("target_user_embedding", user)
        return torch.where((user < self.overlapped_num_users)[:, None], mapped, direct)

    def predict(self, batch):
        """Scores of the batch's pairs in the current phase (``predict_fn``,
        `emcdr.py:194-219`); the per-domain phases through K1's forward."""
        if self.phase in ("SOURCE", "TARGET"):
            prefix = self.phase.lower()
            key = self.SOURCE_USER_ID if prefix == "source" else self.TARGET_USER_ID
            ikey = self.SOURCE_ITEM_ID if prefix == "source" else self.TARGET_ITEM_ID
            return gather_dot_forward(*self.pair_rows(*self._names(prefix), batch[key],
                                                      batch[ikey])[:4])
        user = batch[self.TARGET_USER_ID].long()
        item = batch[self.TARGET_ITEM_ID].long()
        if self.mode == "overlap_users":
            user_e = self._mapped_user_e(user)
            item_e = self.rows("target_item_embedding", item)
        else:
            user_e = self.rows("target_user_embedding", user)
            mapped = self._map(self.rows("source_item_embedding", item))
            direct = self.rows("target_item_embedding", item)
            item_e = torch.where((item < self.overlapped_num_items)[:, None], mapped, direct)
        return torch.sum(user_e * item_e, -1)

    def _items(self, phase):
        """The item side of the phase's full-sort score (``whole_items``):
        the target items' prefix, or a block built from the tables gathered
        over the model group under a mesh (SOURCE's two ranges, the
        item-overlap mode's mapped overlap)."""
        n_ov, n_tgt = self.overlapped_num_items, self.target_num_items
        if phase == "SOURCE":
            table = self.full_table("source_item_embedding")
            return torch.cat([table[:n_ov], table[n_tgt:]], 0)
        if phase == "TARGET" or self.mode == "overlap_users":
            return "target_item_embedding", n_tgt
        overlap_item_e = self._map(self.full_table("source_item_embedding")[:n_ov])
        return torch.cat([overlap_item_e, self.full_table("target_item_embedding")[n_ov:n_tgt]],
                         0)

    def _user_repr(self, phase, users):
        if phase == "SOURCE":
            return self.rows("source_user_embedding", users)
        if phase == "TARGET" or self.mode != "overlap_users":
            return self.rows("target_user_embedding", users)
        return self._mapped_user_e(users)

    def full_sort(self, users, phase: str = "TARGET"):
        user_e = self._user_repr(phase, users)
        return torch.matmul(user_e, self.whole_items(self._items(phase)).T)

    def full_sort_factors(self, phase: str = "TARGET"):
        """``users -> (user representation, item table)``: the full-sort
        score is their product (`emcdr.py:262-303`); under a mesh the item
        side is this rank's share of it and its first row."""
        return lambda users: self.item_factors(self._user_repr(phase, users), self._items(phase))
