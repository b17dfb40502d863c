"""SSCDR — Semi-Supervised Cross-Domain Recommendation for cold-start users
(Kang et al., CIKM 2019).

Port of ``recbole_cdr_tpu/models/sscdr.py``, the metric-space variant: a
triplet margin loss per domain (SOURCE and TARGET, on the pairwise
stream); the OVERLAP (mapping) phase adds to a supervised MSE over the
overlapped entities a semi-supervised triplet over mapped source-space
neighbours, one interacted and one non-interacted entity per id, drawn on
the host by ``augment_batch`` (so OVERLAP runs on the trainer's host batch
path). Scoring is the negative squared euclidean distance, expanded as a
matmul for full-sort; there is no dot-product factor form, so evaluation is
dense only. The reference's squared-length "normalize" quirk
(`sscdr.py:119-124`) is kept.

The neighbour tables are built from the whole source domain, the valid and
test interactions included, as in JAX (``src.arrays``).
"""

import numpy as np
import torch

from recbole_cdr_tpu_torch.models.base import CrossDomainRecommender, mlp, weighted_mean
from recbole_cdr_tpu_torch.utils.enums import InputType


class SSCDR(CrossDomainRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mode = self._overlap_mode("SSCDR")

        self.embedding_size = config["embedding_size"]
        self.lamda = float(config["lambda"])
        self.margin = float(config["margin"])
        self.mlp_hidden_size = list(config["mlp_hidden_size"])

        # source-domain interacted sets in CSR form for the neighbour
        # sampling (reference `sscdr.py:74-87`): sorted by (key, val), so
        # key * V + val is globally sorted and membership of a (key, draw)
        # pair is one searchsorted over the batch
        src = dataset.source_domain_dataset
        uids = src.arrays[src.uid_field]
        iids = src.arrays[src.iid_field]
        if self.mode == "overlap_users":
            keys, vals, n_keys = uids, iids, self.total_num_users
            self._candidates = np.concatenate([
                np.arange(self.overlapped_num_items),
                np.arange(self.target_num_items, self.total_num_items)])
        else:
            keys, vals, n_keys = iids, uids, self.total_num_items
            self._candidates = np.concatenate([
                np.arange(self.overlapped_num_users),
                np.arange(self.target_num_users, self.total_num_users)])
        order = np.lexsort((vals, keys))
        self._inter_keys_sorted = keys[order]
        self._inter_vals_sorted = vals[order]
        counts = np.bincount(keys, minlength=n_keys)
        self._ptr = np.concatenate([[0], np.cumsum(counts)])
        self._val_space = np.int64(
            self.total_num_items if self.mode == "overlap_users" else self.total_num_users)
        self._inter_comp = (self._inter_keys_sorted.astype(np.int64) * self._val_space
                            + self._inter_vals_sorted)
        self._rng = np.random.default_rng(config["seed"] or 0)

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        D = self.embedding_size
        self._domain_tables(D, D, gen)
        self.mapping = mlp([D] + self.mlp_hidden_size + [D], gen)

    # --------------------------------------------------------- host sampling

    def needs_host_augment(self, phase):
        return phase == "OVERLAP"

    def augment_batch(self, batch, phase):
        """Semi-supervised neighbour sampling over the whole batch, the JAX
        package's vectorised sampler (`sscdr.py:115-169`), draw for draw:
        pos a uniform draw from the id's interacted set (0 when empty); neg
        a uniform draw from the candidates outside it, by batched rejection
        rounds and an exact complement draw for rows that never drew clean.
        Rows with an empty interacted set reject only a draw of 0."""
        if phase != "OVERLAP":
            return batch
        ids = np.asarray(batch["overlap"], dtype=np.int64)
        B = len(ids)
        lo = self._ptr[ids]
        cnt = self._ptr[ids + 1] - lo

        n_inter = len(self._inter_vals_sorted)
        if n_inter:
            off = (self._rng.random(B) * np.maximum(cnt, 1)).astype(np.int64)
            safe = np.minimum(np.where(cnt > 0, lo + off, 0), n_inter - 1)
            pos = np.where(cnt > 0, self._inter_vals_sorted[safe], 0)
        else:
            pos = np.zeros(B, dtype=np.int64)

        neg = np.zeros(B, dtype=np.int64)
        pending = np.arange(B)
        comp_base = ids * self._val_space
        n_cand = len(self._candidates)
        for _ in range(64):
            if not len(pending):
                break
            draw = self._candidates[self._rng.integers(0, n_cand, len(pending))]
            comp = comp_base[pending] + draw
            if n_inter:
                loc = np.minimum(np.searchsorted(self._inter_comp, comp), n_inter - 1)
                hit = self._inter_comp[loc] == comp
            else:
                hit = np.zeros(len(pending), dtype=bool)
            hit |= (cnt[pending] == 0) & (draw == 0)
            ok = ~hit
            neg[pending[ok]] = draw[ok]
            pending = pending[hit]
        for k in pending:  # exact complement for rows that never drew clean
            i = ids[k]
            interacted = self._inter_vals_sorted[self._ptr[i]:self._ptr[i + 1]]
            if len(interacted) == 0:
                interacted = np.array([0])
            neg[k] = self._rng.choice(np.setdiff1d(self._candidates, interacted))

        batch = dict(batch)
        batch["overlap_pos"] = pos
        batch["overlap_neg"] = neg
        return batch

    # ------------------------------------------------------------ math parts

    @staticmethod
    def _normalize(e):
        """Reference quirk: divide by the SQUARED length when it is > 1."""
        length2 = torch.sum(e ** 2, -1, keepdim=True)
        return e / torch.where(length2 > 1, length2, torch.ones_like(length2))

    @staticmethod
    def _dist2(a, b):
        return torch.sum((a - b) ** 2, -1)

    def _triplet(self, anchor, pos, neg, weight):
        """torch TripletMarginLoss(margin, p=2): euclidean distances."""
        d_pos = torch.sqrt(self._dist2(anchor, pos) + 1e-12)
        d_neg = torch.sqrt(self._dist2(anchor, neg) + 1e-12)
        return weighted_mean(torch.clamp(d_pos - d_neg + self.margin, min=0.0), weight)

    def _map(self, x):
        # recbole MLPLayers(activation='tanh'): tanh after every layer
        for layer in self.mapping:
            x = torch.tanh(layer(x))
        return x

    # ----------------------------------------------------------------- losses

    def trainable_predicate(self, phase: str):
        """The parameters the phase's loss reaches. OVERLAP's
        semi-supervised triplet maps sampled source neighbours, so the other
        entity's source table is live there too."""
        if phase == "SOURCE":
            live = {"source_user_embedding", "source_item_embedding"}
        elif phase == "TARGET":
            live = {"target_user_embedding", "target_item_embedding"}
        elif self.mode == "overlap_users":
            live = {"mapping", "source_user_embedding", "target_user_embedding",
                    "source_item_embedding"}
        else:
            live = {"mapping", "source_item_embedding", "target_item_embedding",
                    "source_user_embedding"}
        return lambda name: name in live

    def sparse_spec(self, phase: str):
        """The triplet phases read the tables only through batch ids;
        OVERLAP runs on the host path and keeps the dense update."""
        if phase == "SOURCE":
            return {"source_user_embedding": [self.SOURCE_USER_ID],
                    "source_item_embedding": [self.SOURCE_ITEM_ID, self.SOURCE_NEG_ITEM_ID]}
        if phase == "TARGET":
            return {"target_user_embedding": [self.TARGET_USER_ID],
                    "target_item_embedding": [self.TARGET_ITEM_ID, self.TARGET_NEG_ITEM_ID]}
        return None

    def _domain_triplet(self, batch, prefix, uid_key, iid_key, neg_key, w_key):
        users, items = f"{prefix}_user_embedding", f"{prefix}_item_embedding"
        ue = self._normalize(self.rows(users, batch[uid_key]))
        pe = self._normalize(self.rows(items, batch[iid_key]))
        ne = self._normalize(self.rows(items, batch[neg_key]))
        return self._triplet(ue, pe, ne, batch[w_key])

    def loss_fn(self, phase: str):
        if phase == "SOURCE":
            return lambda batch, rng=None: self._domain_triplet(
                batch, "source", self.SOURCE_USER_ID, self.SOURCE_ITEM_ID,
                self.SOURCE_NEG_ITEM_ID, "source_sample_weight")
        if phase == "OVERLAP":
            def loss(batch, rng=None):
                idx = batch["overlap"]
                w = batch["overlap_sample_weight"]
                ent, other = (("user", "item") if self.mode == "overlap_users"
                              else ("item", "user"))
                src_e = self.rows(f"source_{ent}_embedding", idx)
                tgt_e = self.rows(f"target_{ent}_embedding", idx)
                neighbours = f"source_{other}_embedding"
                map_pos = self._map(self.rows(neighbours, batch["overlap_pos"]))
                map_neg = self._map(self.rows(neighbours, batch["overlap_neg"]))
                loss_s = weighted_mean(torch.mean((self._map(src_e) - tgt_e) ** 2, -1), w)
                loss_u = self._triplet(self._normalize(tgt_e), self._normalize(map_pos),
                                       self._normalize(map_neg), w)
                return loss_s + self.lamda * loss_u
            return loss
        return lambda batch, rng=None: self._domain_triplet(
            batch, "target", self.TARGET_USER_ID, self.TARGET_ITEM_ID,
            self.TARGET_NEG_ITEM_ID, "target_sample_weight")

    # ---------------------------------------------------------------- scoring

    def _mapped_user_e(self, user):
        mapped = self._map(self.rows("source_user_embedding", user))
        direct = self.rows("target_user_embedding", user)
        return torch.where((user < self.overlapped_num_users)[:, None], mapped, direct)

    def _overlap_tables(self, user):
        """(user rows, item rows) of the mapped scoring (OVERLAP and after)."""
        if self.mode == "overlap_users":
            return (self._mapped_user_e(user),
                    self.target_item_embedding[:self.target_num_items])
        overlap_item_e = self._map(self.source_item_embedding[:self.overlapped_num_items])
        target_item_e = self.target_item_embedding[
            self.overlapped_num_items:self.target_num_items]
        return self.rows("target_user_embedding", user), torch.cat([overlap_item_e, target_item_e], 0)

    def predict(self, batch):
        """Negative squared distances of the batch's pairs (``predict_fn``,
        `sscdr.py:276-301`)."""
        if self.phase in ("SOURCE", "TARGET"):
            prefix = self.phase.lower()
            ukey = self.SOURCE_USER_ID if prefix == "source" else self.TARGET_USER_ID
            ikey = self.SOURCE_ITEM_ID if prefix == "source" else self.TARGET_ITEM_ID
            ue = self._normalize(self.rows(f"{prefix}_user_embedding", batch[ukey]))
            ie = self._normalize(self.rows(f"{prefix}_item_embedding", batch[ikey]))
            return -self._dist2(ue, ie)
        user = batch[self.TARGET_USER_ID].long()
        item = batch[self.TARGET_ITEM_ID].long()
        if self.mode == "overlap_users":
            ue = self._mapped_user_e(user)
            ie = self.rows("target_item_embedding", item)
        else:
            ue = self.rows("target_user_embedding", user)
            mapped = self._map(self.rows("source_item_embedding", item))
            ie = torch.where((item < self.overlapped_num_items)[:, None], mapped,
                             self.rows("target_item_embedding", item))
        return -self._dist2(self._normalize(ue), self._normalize(ie))

    def full_sort(self, users, phase: str = "TARGET"):
        """-||u - i||^2 over the item space, expanded as a matmul
        (`sscdr.py:314-363`)."""
        if phase == "SOURCE":
            user_e = self._normalize(self.rows("source_user_embedding", users))
            item_e = self._normalize(torch.cat([
                self.source_item_embedding[:self.overlapped_num_items],
                self.source_item_embedding[self.target_num_items:]], 0))
        elif phase == "TARGET":
            user_e = self._normalize(self.rows("target_user_embedding", users))
            item_e = self._normalize(self.target_item_embedding[:self.target_num_items])
        else:
            user_e, item_e = (self._normalize(t) for t in self._overlap_tables(users))
        dist = (-2.0 * torch.matmul(user_e, item_e.T)
                + torch.sum(user_e ** 2, -1, keepdim=True)
                + torch.sum(item_e ** 2, -1)[None, :])
        return -dist
