"""CoNet — Collaborative Cross Networks (Hu et al., CIKM 2018).

Port of ``recbole_cdr_tpu/models/conet.py``: twin MLP towers on ``[user_e
|| item_e]``, one per domain, with a cross-stitch unit per layer: on the
overlapped rows each tower adds the other tower's input times the layer's
``cross`` matrix (one matrix per layer, used in both directions). Joint BCE
loss plus the unweighted sum of the cross matrices' norms (``reg_weight`` is
loaded by the reference and used nowhere; so here). The four domain tables
start with each domain's rows outside it zeroed.

Training runs the towers as torch products with autograd, as the JAX
package leaves them to XLA. ``predict`` runs the target tower alone. The
full-sort form goes through kernel B15 (``ops/conet_tower.py``): the first
layer splits into a user half ``u @ W_u``, built per tile, and an item half
``i @ W_i`` over the target item prefix, built once per parameter version;
the kernel adds the layer's bias to their sum and runs the rest of the
tower on every (user, item) pair of the tile without materialising the [B,
I, H0] hidden.

Under ``compute_dtype: bfloat16`` (or float16) the trainer hands every call
16-bit copies of the parameters: the towers train in 16 bits, as JAX's
``_coupled_towers`` does under its cast (``reg_loss`` upcasts), and the
full-sort reaches B15's 16-bit form with the item half cached in that type.
"""

import torch
from torch import nn

from recbole_cdr_tpu_torch.models.base import (
    CrossDomainRecommender,
    Linear,
    bce_loss,
    mlp,
    reg_loss,
    xavier_normal,
)
from recbole_cdr_tpu_torch.ops.conet_tower import conet_tower
from recbole_cdr_tpu_torch.utils.enums import InputType


class CoNet(CrossDomainRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.mode = self._overlap_mode("CoNet")
        self.latent_dim = config["embedding_size"]
        self.reg_weight = float(config["reg_weight"])
        self.cross_layers = list(config["mlp_hidden_size"])

        gen = torch.Generator().manual_seed(int(config["seed"] or 2022))
        self._domain_tables(self.latent_dim, self.latent_dim, gen)
        dims = [2 * self.latent_dim] + self.cross_layers
        self.source_tower = mlp(dims, gen)
        self.target_tower = mlp(dims, gen)
        self.source_out = Linear(self.cross_layers[-1], 1, gen)
        self.target_out = Linear(self.cross_layers[-1], 1, gen)
        #: the cross matrices, [d_in, d_out] (applied as x @ W)
        self.cross = nn.ParameterList(
            nn.Parameter(xavier_normal((dims[i], dims[i + 1]), gen)) for i in range(len(dims) - 1))

    # ------------------------------------------------------------------ parts

    def _coupled_towers(self, user, item):
        """Both towers with the cross-stitch on the overlapped rows
        (`conet.py:83-105`): the final hidden of (source, target)."""
        user, item = user.long(), item.long()
        embed = nn.functional.embedding
        src_x = torch.cat([embed(user, self.source_user_embedding),
                           embed(item, self.source_item_embedding)], -1)
        tgt_x = torch.cat([embed(user, self.target_user_embedding),
                           embed(item, self.target_item_embedding)], -1)
        if self.mode == "overlap_users":
            overlap = user < self.overlapped_num_users
        else:
            overlap = item < self.overlapped_num_items
        overlap = overlap[:, None].to(src_x.dtype)
        for s_layer, t_layer, cross in zip(self.source_tower, self.target_tower, self.cross):
            s_out = s_layer(src_x) + overlap * (tgt_x @ cross)
            t_out = t_layer(tgt_x) + overlap * (src_x @ cross)
            src_x, tgt_x = torch.relu(s_out), torch.relu(t_out)
        return src_x, tgt_x

    def _target_tower_only(self, x):
        for layer in self.target_tower:
            x = torch.relu(layer(x))
        return x

    # ------------------------------------------------------------------ losses

    def loss(self, batch, rng=None):
        s_hidden, _ = self._coupled_towers(batch[self.SOURCE_USER_ID], batch[self.SOURCE_ITEM_ID])
        _, t_hidden = self._coupled_towers(batch[self.TARGET_USER_ID], batch[self.TARGET_ITEM_ID])
        s_logit = self.source_out(s_hidden).squeeze(-1)
        t_logit = self.target_out(t_hidden).squeeze(-1)
        loss_s = bce_loss(s_logit, batch[self.SOURCE_LABEL], batch["source_sample_weight"])
        loss_t = bce_loss(t_logit, batch[self.TARGET_LABEL], batch["target_sample_weight"])
        # parity: the unweighted sum of the cross matrices' norms (`conet.py:198-201`)
        return loss_s + loss_t + reg_loss(list(self.cross))

    def loss_fn(self, phase: str):
        return self.loss

    # ----------------------------------------------------------------- scoring

    def predict(self, batch):
        user = batch[self.TARGET_USER_ID].long()
        item = batch[self.TARGET_ITEM_ID].long()
        x = torch.cat([self.target_user_embedding[user], self.target_item_embedding[item]], -1)
        return torch.sigmoid(self.target_out(self._target_tower_only(x)).squeeze(-1))

    def _item_half(self):
        """``i @ W_i`` of every target item, once per parameter version
        (``params_version``, bumped by the training step and by
        ``load_state_dict``) and compute type: an evaluation pass builds it
        once."""
        w_i = self.target_tower[0].w[self.latent_dim:]

        def build():
            with torch.no_grad():
                return torch.matmul(self.target_item_embedding[:self.target_num_items], w_i)
        return self._per_version(f"item_half:{w_i.dtype}", build)

    def full_sort(self, users, phase: str = "TARGET"):
        """[B, target_num_items] probabilities of the target tower, through
        one B15 launch (its 16-bit form under a 16-bit ``compute_dtype``)."""
        first = self.target_tower[0]
        hu = torch.matmul(self.target_user_embedding[users.long()], first.w[:self.latent_dim])
        layers = [(layer.w, layer.b) for layer in self.target_tower[1:]]
        return conet_tower(hu, self._item_half(), first.b, layers,
                           (self.target_out.w, self.target_out.b))
