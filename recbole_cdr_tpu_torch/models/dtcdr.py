"""DTCDR — Dual-Target Cross-Domain Recommendation (Zhu et al., CIKM 2019).

Port of ``recbole_cdr_tpu/models/dtcdr.py``: a NeuMF or DMF base per domain;
each pair's user and item representations combine the two domains' tables
elementwise by ``maximum``. BCE objective ``alpha * source + (1 - alpha) *
target``. The JAX package's two fixes over the reference carry over: plain
xavier everywhere (the reference's +/-inf fills are clobbered by its own
initialisation), and DMF scores the target batch through the target towers
with the item's history.

- NeuMF: the maxed embeddings of user and item, concatenated, through
  recbole's MLP (Dropout -> Linear -> ReLU per layer) and a linear head.
  Training dropout draws its bits from the epoch loop's ``rng(layer,
  domain, shape)``, as BiTGCF's does, not from ``jax.random.bernoulli``.
- DMF: four towers, each the product of an id's binary rating vector over
  its history with a linear table, through kernel B11
  (``ops/rating_vector.py``; its 16-bit form B11-bf16 on the 16-bit copies
  of ``compute_dtype: bfloat16``, still summing into float32 as JAX's
  float32 vector promotes the product, so the towers and the logits stay
  float32 there, the ``fc`` weights upcast by :class:`Linear`): a user's
  source and target item histories, an
  item's source and target user histories (source ids compacted into the
  dense source axis, ``[overlap | source-only]``). A training step makes one
  B11 launch per table, forward and backward, over both domains' ids, and
  one ``group_rows`` launch that groups both sides' ids (users, items) on
  the model's two kept ``RowPlan``s; both tables of a side and both
  directions read that side's grouping. The
  histories are CSRs of each row's distinct non-PAD entries, each with the
  kernels' layout (its transpose and the pieces of its long rows): the JAX
  package's padded ``[rows, max degree]`` matrices would take ~1.2 GB of host
  memory at the smoke pair's widths. Like NATR's, they hold every
  interaction of the domain, the valid and test splits' included.

No full-sort form, as in JAX: the trainer scores through :meth:`predict_grid`,
the predict fallback. In evaluation (``model.eval()``) ``predict`` and
``predict_grid`` read tower tables built once per parameter version: DMF's
target user and item towers of every target id (four B11 launches and one
``group_rows`` a pass), NeuMF's maxed embeddings.
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
from recbole_cdr_tpu_torch.ops.graph_layer import keep_mask
from recbole_cdr_tpu_torch.ops.rating_vector import (
    HistoryCSR,
    HistoryLayout,
    history_csr,
    history_tensors,
    rating_vector,
)
from recbole_cdr_tpu_torch.ops.row_groups import RowPlan, group_rows
from recbole_cdr_tpu_torch.utils.enums import InputType

#: DMF's histories: name -> (domain, history of users or of items)
_HISTORIES = {"s_items": ("source", "user"), "t_items": ("target", "user"),
              "s_users": ("source", "item"), "t_users": ("target", "item")}
#: the table each history's rows sum (its rows are the history's columns)
_TABLES = {"s_items": "source_user_linear", "t_items": "target_user_linear",
           "s_users": "source_item_linear", "t_users": "target_item_linear"}


class DTCDR(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.mlp_hidden_size = list(config["mlp_hidden_size"])
        self.dropout_prob = float(config["dropout_prob"])
        self.base_model = config["base_model"]
        self.alpha = float(config["alpha"])
        assert self.base_model in ("NeuMF", "DMF"), f"based model {self.base_model} is not supported! "

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        D = self.embedding_size

        def stack(dims):
            return nn.ModuleList(Linear(dims[i], dims[i + 1], gen) for i in range(len(dims) - 1))

        if self.base_model == "NeuMF":
            for name, n in (("source_user_embedding", self.total_num_users),
                            ("source_item_embedding", self.total_num_items),
                            ("target_user_embedding", self.total_num_users),
                            ("target_item_embedding", self.total_num_items)):
                setattr(self, name, nn.Parameter(init_embedding(n, D, gen)))
            dims = [2 * D] + self.mlp_hidden_size
            self.source_mlp, self.target_mlp = stack(dims), stack(dims)
            self.source_predict = Linear(self.mlp_hidden_size[-1], 1, gen)
            self.target_predict = Linear(self.mlp_hidden_size[-1], 1, gen)
            return

        self._build_histories(dataset)
        for name, n in (("source_user_linear", self.source_num_items),
                        ("source_item_linear", self.source_num_users),
                        ("target_user_linear", self.target_num_items),
                        ("target_item_linear", self.target_num_users)):
            setattr(self, name, nn.Parameter(xavier_normal((n, D), gen)))
        fc_dims = [D] + self.mlp_hidden_size
        self.source_user_fc, self.source_item_fc = stack(fc_dims), stack(fc_dims)
        self.target_user_fc, self.target_item_fc = stack(fc_dims), stack(fc_dims)

    def _build_histories(self, dataset):
        """The four CSR histories and their kernel layouts as buffers (moved
        by .to(), kept out of the state dict): rows over the unified id
        space, source columns compacted (`dtcdr.py:52-56`)."""
        gap = {"item": self.target_num_items - self.overlapped_num_items,
               "user": self.target_num_users - self.overlapped_num_users}
        n_overlap = {"item": self.overlapped_num_items, "user": self.overlapped_num_users}
        n_rows = {"user": self.total_num_users, "item": self.total_num_items}
        n_cols = {"s_items": self.source_num_items, "t_items": self.target_num_items,
                  "s_users": self.source_num_users, "t_users": self.target_num_users}
        for name, (domain, row) in _HISTORIES.items():
            ds = getattr(dataset, f"{domain}_domain_dataset")
            uids, iids = ds.arrays[ds.uid_field], ds.arrays[ds.iid_field]
            rows, cols, col = (uids, iids, "item") if row == "user" else (iids, uids, "user")
            if domain == "source":
                cols = cols - gap[col] * (cols >= n_overlap[col])
            csr = history_tensors(*history_csr(rows, cols, n_rows[row]), n_cols[name])
            for field, value in (*zip(("ptr", "cols"), csr[:2]),
                                 *zip(HistoryLayout._fields, csr.layout)):
                self.register_buffer(f"{name}_{field}", value, persistent=False)

    def _csr(self, name):
        return HistoryCSR(getattr(self, f"{name}_ptr"), getattr(self, f"{name}_cols"),
                          HistoryLayout(*(getattr(self, f"{name}_{field}")
                                          for field in HistoryLayout._fields)))

    # ------------------------------------------------------------------ NeuMF

    def _mlp(self, layers, x, rng=None, domain=None):
        """recbole's MLPLayers: Dropout -> Linear -> ReLU per layer; dropout
        only with the step's random bits."""
        keep = 1.0 - self.dropout_prob
        for i, layer in enumerate(layers):
            if rng is not None and self.dropout_prob > 0:
                x = torch.where(keep_mask(rng(i, domain, x.shape), keep), x / keep, 0.0)
            x = torch.relu(layer(x))
        return x

    def _neumf_head(self, user_e, item_e, domain, rng=None):
        h = self._mlp(getattr(self, f"{domain}_mlp"), torch.cat([user_e, item_e], -1), rng, domain)
        return getattr(self, f"{domain}_predict")(h).squeeze(-1)

    def _neumf_embeddings(self, user, item):
        return (torch.maximum(self.rows("source_user_embedding", user),
                              self.rows("target_user_embedding", user)),
                torch.maximum(self.rows("source_item_embedding", item),
                              self.rows("target_item_embedding", item)))

    # -------------------------------------------------------------------- DMF

    def _row_plans(self, device):
        """The kept plans of the two sides' history rows on ``device``
        (users over ``total_num_users`` rows, items over
        ``total_num_items``): the one source of B11's groupings."""
        plans = self.__dict__.setdefault("_dmf_plans", {})
        if device not in plans:
            plans[device] = (RowPlan(self.total_num_users, device),
                             RowPlan(self.total_num_items, device))
        return plans[device]

    def _dmf_embeddings(self, user, item):
        """The towers' inputs of pairs (``user``, ``item``): four B11
        launches, one per linear table, from one ``group_rows`` launch for
        both sides. On the card a grouping is its plan's own object and holds
        until the next grouping on that plan; only this method groups on
        these plans, and a step's backward runs before the next step's loss
        or evaluation pass calls it again, so the backwards read the
        groupings of their own forward."""
        user, item = user.to(torch.int32), item.to(torch.int32)
        user_plan, item_plan = self._row_plans(user.device)
        user_groups, item_groups = group_rows(user, user_plan, second=(item, item_plan))

        def side(names, ids, groups):
            return torch.maximum(*(rating_vector(self._csr(n), getattr(self, _TABLES[n]), ids,
                                                 groups) for n in names))

        return (side(("s_items", "t_items"), user, user_groups),
                side(("s_users", "t_users"), item, item_groups))

    def _dmf_head(self, user_e, item_e, domain):
        user_h = self._mlp(getattr(self, f"{domain}_user_fc"), user_e)
        item_h = self._mlp(getattr(self, f"{domain}_item_fc"), item_e)
        return torch.sum(user_h * item_h, -1)

    # ----------------------------------------------------------------- losses

    def loss(self, batch, rng=None):
        su, si = batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]
        tu, ti = batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]
        if self.base_model == "NeuMF":
            s_logit = self._neumf_head(*self._neumf_embeddings(su, si), "source", rng)
            t_logit = self._neumf_head(*self._neumf_embeddings(tu, ti), "target", rng)
        else:  # both domains' pairs in one launch per table
            user_e, item_e = self._dmf_embeddings(torch.cat([su, tu]), torch.cat([si, ti]))
            n = su.shape[0]
            s_logit = self._dmf_head(user_e[:n], item_e[:n], "source")
            t_logit = self._dmf_head(user_e[n:], item_e[n:], "target")
        loss_s = bce_loss(s_logit, batch[self.SOURCE_LABEL], batch["source_sample_weight"])
        loss_t = bce_loss(t_logit, batch[self.TARGET_LABEL], batch["target_sample_weight"])
        return loss_s * self.alpha + loss_t * (1.0 - self.alpha)

    def loss_fn(self, phase: str):
        return self.loss

    # ---------------------------------------------------------------- scoring

    def _tower_tables(self):
        """(user rows [target users, .], item rows [target items, .]) of the
        target domain, built once per parameter version: DMF's towers after
        the target fc stacks (four B11 launches), NeuMF's maxed embeddings."""
        nu, ni = self.target_num_users, self.target_num_items

        @torch.no_grad()
        def build():
            if self.base_model == "NeuMF":
                return (torch.maximum(self.source_user_embedding[:nu],
                                      self.target_user_embedding[:nu]),
                        torch.maximum(self.source_item_embedding[:ni],
                                      self.target_item_embedding[:ni]))
            dev = self.source_user_linear.device
            user_e, item_e = self._dmf_embeddings(torch.arange(nu, device=dev),
                                                  torch.arange(ni, device=dev))
            return self._mlp(self.target_user_fc, user_e), self._mlp(self.target_item_fc, item_e)
        return self._per_version("tower_tables", build)

    def predict(self, batch):
        """Target probabilities of the pairs of ``batch`` (``predict_fn``,
        `dtcdr.py:183-191`); in evaluation from the tower tables."""
        user, item = batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]
        if self.training:
            if self.base_model == "NeuMF":
                logit = self._neumf_head(*self._neumf_embeddings(user, item), "target")
            else:
                logit = self._dmf_head(*self._dmf_embeddings(user, item), "target")
            return torch.sigmoid(logit)
        users_t, items_t = self._tower_tables()
        u, i = users_t[user.long()], items_t[item.long()]
        if self.base_model == "NeuMF":
            return torch.sigmoid(self._neumf_head(u, i, "target"))
        return torch.sigmoid(torch.sum(u * i, -1))

    def predict_grid(self, users, items):
        """Probabilities of every pair of ``users [B]`` x ``items [I]`` from
        the pass's tower tables: DMF's as one [B, I] product of the towers,
        NeuMF's through the MLP over the grid's pairs."""
        users_t, items_t = self._tower_tables()
        u, i = users_t[users.long()], items_t[items.long()]
        if self.base_model == "DMF":
            return torch.sigmoid(u @ i.T)
        B, n = u.shape[0], i.shape[0]
        logit = self._neumf_head(u[:, None, :].expand(B, n, -1), i[None, :, :].expand(B, n, -1),
                                 "target")
        return torch.sigmoid(logit)

    def full_sort_fn(self, phase: str = "TARGET"):
        """None: DTCDR scores through the predict fallback, as in JAX."""
        return None
