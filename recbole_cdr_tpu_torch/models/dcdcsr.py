"""DCDCSR — Deep framework for Cross-Domain and Cross-System Recommendations
(Zhu et al., IJCAI 2018).

Port of ``recbole_cdr_tpu/models/dcdcsr.py``. Schedule ``SOURCE, TARGET,
BOTH, TARGET``: BPR latent factors per domain; on entry into BOTH a
"benchmark" table is built (overlapped rows: a popularity-weighted blend of
the two domains' rows; the other rows: a blend with the top-k most similar
overlapped source rows, kernel B12, ``ops/benchmark_topk.py``) and a tanh
MLP learns to map the target factors onto it, on the host batch path (each
batch draws its ``map_sample_idx`` on the host); on entry into the second
TARGET the overlapped side's target table is mapped through the MLP into a
frozen affine table, and BPR retrains the other side against it.

The benchmark and affine tables are buffers, not parameters (JAX keeps them
in the parameter tree, masked out of every update): they change shape on
phase entry, ``[1, D]`` to ``[n_total, D]`` and ``[n_units, D]``, which
``CrossDomainRecommender.load_state_dict`` accepts. The BPR dots of a step,
positives and negatives, go through one call of kernel K1
(``ops/gather_dot.py``). The popularities are the interaction counts of the
whole domain, the valid and test splits' included, as in JAX.

Under a (data, model) mesh (``MESH_READY``) the losses read the tables
through ``rows`` and take their batch sums through ``batch_sums``; BOTH's
``map_sample_idx`` is split over ``data`` with the rest of the host batch,
so its mean goes through ``batch_sums`` with its own count. The
phase-entry surgery reads prefixes of row-sharded tables: it runs on the
tables gathered over the model group (``full_table``), so every rank builds
the same benchmark (B12) and affine tables, and both stay replicated
buffers. The SOURCE phase's item block joins two disjoint ranges of the
source item table, so it is built the same way and every model rank scores
its share of it (``item_factors``).
"""

import numpy as np
import torch

from recbole_cdr_tpu_torch.models.base import CrossDomainRecommender, bpr_terms, mlp
from recbole_cdr_tpu_torch.ops.benchmark_topk import benchmark_topk
from recbole_cdr_tpu_torch.ops.gather_dot import gather_dot, gather_dot_forward
from recbole_cdr_tpu_torch.utils.enums import InputType


class DCDCSR(CrossDomainRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mode = self._overlap_mode("DCDCSR")
        self.phase2count = {"SOURCE": 0, "TARGET": 0, "BOTH": 0, "OVERLAP": 0}

        self.latent_factor_model = config["latent_factor_model"]
        assert self.latent_factor_model in ("BPR",), "latent_factor model must be in [BPR]"
        self.embedding_size = config["embedding_size"]
        self.mlp_hidden_size = list(config["mlp_hidden_size"])
        self.k = config["k"]
        self.map_batch_size = config["map_batch_size"]

        # per-unit interaction counts of each domain (the JAX package's
        # history-matrix lengths, `dcdcsr.py:56-61`)
        if self.mode == "overlap_users":
            field, n = "uid_field", self.total_num_users
        else:
            field, n = "iid_field", self.total_num_items
        for name, ds in (("_source_pop", dataset.source_domain_dataset),
                         ("_target_pop", dataset.target_domain_dataset)):
            pop = np.bincount(ds.arrays[getattr(ds, field)], minlength=n)
            self.register_buffer(name, torch.as_tensor(pop, dtype=torch.float32),
                                 persistent=False)
        self._rng = np.random.default_rng(config["seed"] or 0)

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        D = self.embedding_size
        self._domain_tables(D, D, gen)
        self.mapping = mlp([D] + self.mlp_hidden_size + [D], gen)
        # derived tables, rebuilt on phase entry (mutate_params_on_phase)
        self.register_buffer("benchmark_embedding", torch.zeros(1, D))
        self.register_buffer("affine_embedding", torch.zeros(1, D))

    #: trains and evaluates under ``mesh_shape``
    MESH_READY = True

    # ------------------------------------------------------------ phase hooks

    def set_phase(self, phase):
        self.phase = phase
        self.phase2count[phase] += 1

    def trainable_predicate(self, phase):
        """The parameters the phase's loss reaches (torch's optimizers
        advance state only for parameters with a gradient)."""
        count = self.phase2count.get(phase, 0)
        if phase == "SOURCE":
            live = {"source_user_embedding", "source_item_embedding"}
        elif phase == "BOTH":
            # the map loss flows through the sampled unit rows into their table
            unit = ("target_user_embedding" if self.mode == "overlap_users"
                    else "target_item_embedding")
            live = {"mapping", unit}
        elif phase == "TARGET" and count == 2:
            # the affine side is a frozen buffer: BPR reaches the other table
            live = ({"target_item_embedding"} if self.mode == "overlap_users"
                    else {"target_user_embedding"})
        else:
            live = {"target_user_embedding", "target_item_embedding"}
        return lambda name: name in live

    def sparse_spec(self, phase):
        """BPR phases read their tables only through batch ids. BOTH runs on
        the host path and keeps the dense update; in the second TARGET the
        affine side is a buffer."""
        count = self.phase2count.get(phase, 0)
        if phase == "SOURCE":
            return {"source_user_embedding": [self.SOURCE_USER_ID],
                    "source_item_embedding": [self.SOURCE_ITEM_ID, self.SOURCE_NEG_ITEM_ID]}
        if phase == "TARGET" and count == 2:
            if self.mode == "overlap_users":
                return {"target_item_embedding": [self.TARGET_ITEM_ID,
                                                  self.TARGET_NEG_ITEM_ID]}
            return {"target_user_embedding": [self.TARGET_USER_ID]}
        if phase == "TARGET":
            return {"target_user_embedding": [self.TARGET_USER_ID],
                    "target_item_embedding": [self.TARGET_ITEM_ID, self.TARGET_NEG_ITEM_ID]}
        return None

    def _map(self, x):
        # MLPLayers(activation='tanh'): tanh after every layer
        for layer in self.mapping:
            x = torch.tanh(layer(x))
        return x

    @staticmethod
    def _maxmin_normalize(e):
        min_ = torch.amin(e, dim=1, keepdim=True)
        max_ = torch.amax(e, dim=1, keepdim=True)
        mean_ = (max_ + min_) / 2
        denom = torch.where(max_ - mean_ == 0, torch.ones_like(max_), max_ - mean_)
        return (e - mean_) / denom, mean_, max_

    @torch.no_grad()
    def _build_benchmark(self):
        """The [n_total, D] benchmark table (`dcdcsr.py:154-191`): the
        overlapped rows' popularity-weighted blend here, the other rows'
        top-k blend by kernel B12."""
        if self.mode == "overlap_users":
            n_total, n_ov = self.total_num_users, self.overlapped_num_users
            src_overlap = self.full_table("source_user_embedding")[:n_ov]
            tgt_emb = self.full_table("target_user_embedding")
        else:
            n_total, n_ov = self.total_num_items, self.overlapped_num_items
            src_overlap = self.full_table("source_item_embedding")[:n_ov]
            tgt_emb = self.full_table("target_item_embedding")
        s_pop, t_pop = self._source_pop, self._target_pop

        denom = s_pop[:n_ov] + t_pop[:n_ov]
        denom = torch.where(denom == 0, torch.ones_like(denom), denom)
        alpha_s = (s_pop[:n_ov] / denom)[:, None]
        bench_overlap = alpha_s * tgt_emb[:n_ov] + (1 - alpha_s) * src_overlap

        bench_rest, _, _ = benchmark_topk(tgt_emb[n_ov:n_total], src_overlap, s_pop[:n_ov],
                                          t_pop[n_ov:n_total], min(self.k, n_ov))
        return torch.cat([bench_overlap, bench_rest], 0)

    @torch.no_grad()
    def mutate_params_on_phase(self, phase):
        if phase == "BOTH" and self.mode != "non_overlap":
            self.benchmark_embedding = self._build_benchmark()
            self.notify_params_updated()
        if phase == "TARGET" and self.phase2count["TARGET"] == 2:
            if self.mode == "overlap_users":
                src = self.full_table("target_user_embedding")[:self.target_num_users]
            else:
                src = self.full_table("target_item_embedding")[:self.target_num_items]
            normal, mean_, max_ = self._maxmin_normalize(src)
            self.affine_embedding = self._map(normal) * (max_ - mean_) + mean_
            self.notify_params_updated()

    # --------------------------------------------------------- host sampling

    def needs_host_augment(self, phase):
        return phase == "BOTH"

    def augment_batch(self, batch, phase):
        if phase != "BOTH":
            return batch
        n_units = (self.target_num_users if self.mode == "overlap_users"
                   else self.target_num_items)
        batch = dict(batch)
        batch["map_sample_idx"] = self._rng.integers(
            0, n_units, self.map_batch_size).astype(np.int64)
        return batch

    # ----------------------------------------------------------------- losses

    def _bpr(self, batch, user_table, item_table, uid_key, iid_key, neg_key, w_key):
        """BPR over the step's pairs of tables ``user_table`` and
        ``item_table`` (names), positives and negatives scored by one K1
        call."""
        u, n = batch[uid_key], batch[uid_key].shape[0]
        scores = gather_dot(*self.pair_rows(user_table, item_table, torch.cat([u, u]),
                                            torch.cat([batch[iid_key], batch[neg_key]])))
        return self.batch_mean(bpr_terms(scores[:n], scores[n:]), batch[w_key])

    def loss_fn(self, phase: str):
        count = self.phase2count.get(phase, 0)
        if phase == "SOURCE":
            return lambda batch, rng=None: self._bpr(
                batch, "source_user_embedding", "source_item_embedding",
                self.SOURCE_USER_ID, self.SOURCE_ITEM_ID, self.SOURCE_NEG_ITEM_ID,
                "source_sample_weight")
        if phase == "BOTH":
            def loss(batch, rng=None):
                idx = batch["map_sample_idx"]
                unit = ("target_user_embedding" if self.mode == "overlap_users"
                        else "target_item_embedding")
                unit_n, _, _ = self._maxmin_normalize(self.rows(unit, idx))
                bench_n, _, _ = self._maxmin_normalize(self.rows("benchmark_embedding", idx))
                sq = (self._map(unit_n) - bench_n) ** 2
                # the mean over the global sample: its own count, not a weight's
                total, count = self.batch_sums(torch.sum(sq), sq.new_tensor(float(sq.numel())))
                return total / count
            return loss
        if phase == "TARGET" and count == 2:
            if self.mode == "overlap_users":
                tables = ("affine_embedding", "target_item_embedding")
            else:
                tables = ("target_user_embedding", "affine_embedding")
            return lambda batch, rng=None: self._bpr(
                batch, *tables, self.TARGET_USER_ID, self.TARGET_ITEM_ID,
                self.TARGET_NEG_ITEM_ID, "target_sample_weight")
        return lambda batch, rng=None: self._bpr(
            batch, "target_user_embedding", "target_item_embedding",
            self.TARGET_USER_ID, self.TARGET_ITEM_ID, self.TARGET_NEG_ITEM_ID,
            "target_sample_weight")

    # ---------------------------------------------------------------- scoring

    def _scoring_tables(self, phase):
        """The names of the user and item tables the phase scores with."""
        count = self.phase2count.get(phase, 0)
        use_affine = (phase == "TARGET" and count >= 2) or phase in ("OVERLAP", "BOTH")
        if use_affine and self.mode == "overlap_users":
            return "affine_embedding", "target_item_embedding"
        if use_affine and self.mode == "overlap_items":
            return "target_user_embedding", "affine_embedding"
        return "target_user_embedding", "target_item_embedding"

    def _scorers(self, phase):
        """The phase's user table and the item side of its full-sort score
        (``whole_items``): a prefix of the target item table, the affine
        buffer, or SOURCE's compacted item space (overlap prefix ++
        source-only suffix) built from the table gathered over the model
        group under a mesh."""
        if phase == "SOURCE":
            table = self.full_table("source_item_embedding")
            return "source_user_embedding", torch.cat(
                [table[:self.overlapped_num_items], table[self.target_num_items:]], 0)
        user_table, item_table = self._scoring_tables(phase)
        if item_table == "affine_embedding":  # a replicated buffer
            return user_table, self.affine_embedding[:self.target_num_items]
        return user_table, (item_table, self.target_num_items)

    def predict(self, batch):
        """Scores of the batch's pairs (``predict_fn``, `dcdcsr.py:294-309`)
        through K1's forward."""
        if self.phase == "SOURCE" and self.phase2count["SOURCE"] == 1:
            tables = ("source_user_embedding", "source_item_embedding")
            keys = (self.SOURCE_USER_ID, self.SOURCE_ITEM_ID)
        else:
            tables = self._scoring_tables(self.phase)
            keys = (self.TARGET_USER_ID, self.TARGET_ITEM_ID)
        return gather_dot_forward(*self.pair_rows(*tables, batch[keys[0]], batch[keys[1]])[:4])

    def full_sort(self, users, phase: str = "TARGET"):
        user_table, items = self._scorers(phase)
        return torch.matmul(self.rows(user_table, users), self.whole_items(items).T)

    def full_sort_factors(self, phase: str = "TARGET"):
        """``users -> (user rows, item table)``; under a mesh the item side
        is this rank's share of it and its first row."""
        def factors(users):
            user_table, items = self._scorers(phase)
            return self.item_factors(self.rows(user_table, users), items)
        return factors
