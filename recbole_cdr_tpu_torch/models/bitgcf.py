"""BiTGCF — Bi-directional Transfer Graph Collaborative Filtering
(Liu et al., CIKM 2020).

Port of ``recbole_cdr_tpu/models/bitgcf.py``: LightGCN-style propagation per
domain on the symmetric-normalised bipartite adjacency, with a per-layer
bi-directional transfer (lambda blend plus a degree-weighted blend of the
overlapped rows). Layer outputs are L2-normalised and aggregated by concat
or mean. Joint BCE + EmbLoss on the ego embeddings.

Each graph layer is one call of kernel B8 (``ops/graph_layer.py``): the
sparse-dense product on the adjacency's CSR, the epilogue and the training
dropout, with its backward on the transpose's CSR. The transfer layer and
the normalisation are plain elementwise torch. The pair scores of a step go
through kernel K1 (``ops/gather_dot.py``), one call per domain on the
propagated tables.

Evaluation propagates once per parameter version (``params_version``, bumped
by the training step and by ``load_state_dict``) and serves every user tile
of the pass from that cache, as the JAX package's ``_eval_embeddings`` does.
"""

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    bce_loss,
    emb_loss,
    init_embedding,
)
from recbole_cdr_tpu_torch.ops.gather_dot import gather_dot
from recbole_cdr_tpu_torch.ops.graph_layer import CSR, csr_from_scipy, graph_layer
from recbole_cdr_tpu_torch.utils.enums import InputType
from recbole_cdr_tpu_torch.utils.precision import require_float32_compute


def _norm_adj(interaction_coo, n_users, n_items):
    """D^-1/2 (A) D^-1/2 over the bipartite graph (reference `bitgcf.py:92-116`)."""
    n = n_users + n_items
    rows = np.concatenate([interaction_coo.row, interaction_coo.col + n_users])
    cols = np.concatenate([interaction_coo.col + n_users, interaction_coo.row])
    data = np.ones(len(rows), dtype=np.float32)
    A = sp.coo_matrix((data, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    deg = np.asarray((A > 0).sum(axis=1)).flatten() + 1e-7
    d_inv_sqrt = np.power(deg, -0.5)
    D = sp.diags(d_inv_sqrt)
    L = sp.coo_matrix(D @ A @ D)
    return L


class BiTGCF(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        require_float32_compute(config, "BiTGCF (kernel B8)")
        self.latent_dim = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.reg_weight = float(config["reg_weight"])
        self.lambda_source = float(config["lambda_source"])
        self.lambda_target = float(config["lambda_target"])
        self.drop_rate = float(config["drop_rate"])
        self.connect_way = config["connect_way"]

        src_inter = dataset.inter_matrix(form="coo", domain="source").astype(np.float32)
        tgt_inter = dataset.inter_matrix(form="coo", domain="target").astype(np.float32)
        nu, ni = self.total_num_users, self.total_num_items
        # the adjacencies and degrees are buffers (moved by .to(), kept out
        # of the state dict); each adjacency also as its transpose's CSR, for
        # the backward
        for domain, inter in (("source", src_inter), ("target", tgt_inter)):
            L = _norm_adj(inter, nu, ni).astype(np.float32)
            for name, m in (("adj", L), ("adj_t", L.T)):
                for field, t in zip(CSR._fields, csr_from_scipy(m)):
                    self.register_buffer(f"{domain}_{name}_{field}", t, persistent=False)
        degrees = {
            "source_user_deg": src_inter.sum(axis=1), "target_user_deg": tgt_inter.sum(axis=1),
            "source_item_deg": src_inter.sum(axis=0), "target_item_deg": tgt_inter.sum(axis=0),
        }
        for name, d in degrees.items():
            self.register_buffer(
                name, torch.as_tensor(np.asarray(d).reshape(-1, 1), dtype=torch.float32),
                persistent=False)

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        tables = {
            "source_user_embedding": init_embedding(nu, self.latent_dim, gen),
            "target_user_embedding": init_embedding(nu, self.latent_dim, gen),
            "source_item_embedding": init_embedding(ni, self.latent_dim, gen),
            "target_item_embedding": init_embedding(ni, self.latent_dim, gen),
        }
        tables["source_user_embedding"][self.overlapped_num_users:self.target_num_users] = 0.0
        tables["source_item_embedding"][self.overlapped_num_items:self.target_num_items] = 0.0
        tables["target_user_embedding"][self.target_num_users:] = 0.0
        tables["target_item_embedding"][self.target_num_items:] = 0.0
        for name, t in tables.items():
            setattr(self, name, nn.Parameter(t))

    def _adj(self, domain):
        """(the adjacency's CSR, its transpose's CSR) of a domain."""
        return tuple(CSR(*(getattr(self, f"{domain}_{name}_{field}") for field in CSR._fields))
                     for name in ("adj", "adj_t"))

    # ------------------------------------------------------------ propagation

    def _graph_layer(self, domain, x, bits):
        keep = 1.0 - self.drop_rate
        return graph_layer(x, *self._adj(domain), bits, keep)

    def _transfer_layer(self, src_all, tgt_all):
        nu = self.total_num_users
        su, si = src_all[:nu], src_all[nu:]
        tu, ti = tgt_all[:nu], tgt_all[nu:]

        su_lam = self.lambda_source * su + (1 - self.lambda_source) * tu
        tu_lam = self.lambda_target * tu + (1 - self.lambda_target) * su
        si_lam = self.lambda_source * si + (1 - self.lambda_source) * ti
        ti_lam = self.lambda_target * ti + (1 - self.lambda_target) * si

        user_lap_den = self.source_user_deg + self.target_user_deg + 1e-7
        u_lap = (self.source_user_deg * su + self.target_user_deg * tu) / user_lap_den
        item_lap_den = self.source_item_deg + self.target_item_deg + 1e-7
        i_lap = (self.source_item_deg * si + self.target_item_deg * ti) / item_lap_den

        n_ou, n_oi = self.overlapped_num_users, self.overlapped_num_items
        su_new = torch.cat([(su_lam[:n_ou] + u_lap[:n_ou]) / 2, su[n_ou:]])
        tu_new = torch.cat([(tu_lam[:n_ou] + u_lap[:n_ou]) / 2, tu[n_ou:]])
        si_new = torch.cat([(si_lam[:n_oi] + i_lap[:n_oi]) / 2, si[n_oi:]])
        ti_new = torch.cat([(ti_lam[:n_oi] + i_lap[:n_oi]) / 2, ti[n_oi:]])
        return torch.cat([su_new, si_new]), torch.cat([tu_new, ti_new])

    @staticmethod
    def _l2_normalize(x):
        # zero-safe, as the JAX package: clamping the squared norm keeps the
        # gradient of the blanked sections' zero rows exactly zero
        return x * torch.rsqrt(torch.clamp_min((x * x).sum(1, keepdim=True), 1e-24))

    def _forward(self, rng=None):
        """(source users, source items, target users, target items), each
        [rows, D * (n_layers + 1)] for concat or [rows, D] for mean; training
        dropout when ``rng`` is given and ``drop_rate`` > 0."""
        src = torch.cat([self.source_user_embedding, self.source_item_embedding])
        tgt = torch.cat([self.target_user_embedding, self.target_item_embedding])
        src_list, tgt_list = [src], [tgt]
        drop = rng is not None and self.drop_rate > 0
        for layer in range(self.n_layers):
            src = self._graph_layer("source", src,
                                    rng(layer, "src", src.shape) if drop else None)
            tgt = self._graph_layer("target", tgt,
                                    rng(layer, "tgt", tgt.shape) if drop else None)
            src, tgt = self._transfer_layer(src, tgt)
            src_list.append(self._l2_normalize(src))
            tgt_list.append(self._l2_normalize(tgt))

        if self.connect_way == "concat":
            src_all, tgt_all = torch.cat(src_list, 1), torch.cat(tgt_list, 1)
        else:  # mean
            src_all = torch.stack(src_list, 1).mean(1)
            tgt_all = torch.stack(tgt_list, 1).mean(1)
        nu = self.total_num_users
        return src_all[:nu], src_all[nu:], tgt_all[:nu], tgt_all[nu:]

    # ----------------------------------------------------------------- losses

    def loss(self, batch, rng=None):
        su, si = batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID]
        tu, ti = batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID]
        sw, tw = batch["source_sample_weight"], batch["target_sample_weight"]

        s_user_all, s_item_all, t_user_all, t_item_all = self._forward(rng)
        s_logit = gather_dot(s_user_all, s_item_all, su, si)
        t_logit = gather_dot(t_user_all, t_item_all, tu, ti)

        s_loss = bce_loss(s_logit, batch[self.SOURCE_LABEL], sw) + self.reg_weight * emb_loss(
            [self.source_user_embedding[su.long()], self.source_item_embedding[si.long()]], sw)
        t_loss = bce_loss(t_logit, batch[self.TARGET_LABEL], tw) + self.reg_weight * emb_loss(
            [self.target_user_embedding[tu.long()], self.target_item_embedding[ti.long()]], tw)
        return s_loss + t_loss

    def loss_fn(self, phase: str):
        return self.loss

    # ---------------------------------------------------------------- scoring

    def _eval_embeddings(self):
        """The propagated target tables, computed once per parameter
        version, without dropout or autograd."""
        def propagate():
            with torch.no_grad():
                return self._forward()[2:]
        return self._per_version("eval_embeddings", propagate)

    def predict(self, batch):
        """Target scores (logits, as the JAX package's ``predict_fn``,
        `models/bitgcf.py:228-236`) of the pairs of ``batch`` from the
        pass's propagated tables, through K1's forward."""
        t_user_all, t_item_all = self._eval_embeddings()
        return gather_dot(t_user_all, t_item_all, batch[self.TARGET_USER_ID].to(torch.int32),
                          batch[self.TARGET_ITEM_ID].to(torch.int32))

    def full_sort(self, users, phase: str = "TARGET"):
        user_e, item_e = self.full_sort_factors(phase)(users)
        return torch.matmul(user_e, item_e.T)

    def full_sort_factors(self, phase: str = "TARGET"):
        def factors(users):
            t_user_all, t_item_all = self._eval_embeddings()
            return t_user_all[users], t_item_all[:self.target_num_items]

        return factors
