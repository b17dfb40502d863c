"""Abstract cross-domain recommender + shared building blocks.

Port of ``recbole_cdr_tpu/models/base.py``. Where the JAX package keeps
parameters in an explicit pytree threaded through pure functions, a model
here is an ``nn.Module`` whose parameters carry the same names as the JAX
pytree's top-level keys (``utils/convert.py`` maps one onto the other).

Capability parity with ``CrossDomainRecommender``
(`recbole_cdr/model/crossdomain_recommender.py:14-51`) and recbole's
init/loss helpers (`recbole.model.init.xavier_normal_initialization`,
`recbole.model.loss.EmbLoss`).
"""

from typing import Sequence

import torch
from torch import nn

from recbole_cdr_tpu_torch.utils.enums import ModelType


# ----------------------------------------------------------------- init utils

def xavier_normal(shape, generator=None, dtype=torch.float32) -> torch.Tensor:
    """Xavier/Glorot normal over the trailing two dims: std = sqrt(2/(d0+d1))."""
    fan_sum = shape[0] + shape[1] if len(shape) >= 2 else shape[0] * 2
    std = (2.0 / fan_sum) ** 0.5
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def init_embedding(num, dim, generator=None, dtype=torch.float32) -> torch.Tensor:
    return xavier_normal((num, dim), generator, dtype)


# -------------------------------------------------------------------- losses

def weighted_mean(values: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mean over real (unpadded) samples: sum(v*w)/sum(w), in float32."""
    values = values.float()
    weight = weight.float()
    return torch.sum(values * weight) / torch.clamp(torch.sum(weight), min=1.0)


def bce_loss(logits, labels, weight) -> torch.Tensor:
    """Binary cross-entropy on logits (== BCELoss(sigmoid(x), y), stable)."""
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    return weighted_mean(per, weight)


def emb_loss(embeddings: Sequence[torch.Tensor], weight, norm: int = 2,
             require_pow: bool = False) -> torch.Tensor:
    """recbole ``EmbLoss``: sum_i ||E_i||_p [/ p if require_pow] / batch_size,
    restricted to real (unpadded) rows via ``weight``."""
    weight = weight.float()
    denom = torch.clamp(torch.sum(weight), min=1.0)
    total = 0.0
    for e in embeddings:
        w = weight.reshape((-1,) + (1,) * (e.dim() - 1))
        masked = e.float() * w
        if require_pow:
            total = total + torch.sum(torch.abs(masked) ** norm) / norm
        else:
            total = total + torch.sum(torch.abs(masked) ** norm) ** (1.0 / norm)
    return total / denom


# ---------------------------------------------------------------- base class

class CrossDomainRecommender(nn.Module):
    """Holds the domain field names and the eight ID-space counts every model
    uses, plus the phase hook (reference `crossdomain_recommender.py:21-51`)."""

    type = ModelType.CROSSDOMAIN

    def __init__(self, config, dataset):
        super().__init__()
        self.config = config

        self.SOURCE_USER_ID = dataset.source_domain_dataset.uid_field
        self.SOURCE_ITEM_ID = dataset.source_domain_dataset.iid_field
        self.SOURCE_NEG_ITEM_ID = config["source_domain"]["NEG_PREFIX"] + self.SOURCE_ITEM_ID
        self.SOURCE_LABEL = dataset.source_domain_dataset.label_field
        self.source_num_users = dataset.source_domain_dataset.num(self.SOURCE_USER_ID)
        self.source_num_items = dataset.source_domain_dataset.num(self.SOURCE_ITEM_ID)

        self.TARGET_USER_ID = dataset.target_domain_dataset.uid_field
        self.TARGET_ITEM_ID = dataset.target_domain_dataset.iid_field
        self.TARGET_NEG_ITEM_ID = config["target_domain"]["NEG_PREFIX"] + self.TARGET_ITEM_ID
        self.TARGET_LABEL = dataset.target_domain_dataset.label_field
        self.target_num_users = dataset.target_domain_dataset.num(self.TARGET_USER_ID)
        self.target_num_items = dataset.target_domain_dataset.num(self.TARGET_ITEM_ID)

        self.total_num_users = dataset.num_total_user
        self.total_num_items = dataset.num_total_item
        self.overlapped_num_users = dataset.num_overlap_user
        self.overlapped_num_items = dataset.num_overlap_item

        self.OVERLAP_ID = dataset.overlap_id_field
        self.phase = None

    # -- phase machinery ----------------------------------------------------

    def set_phase(self, phase: str):
        """Host-side phase switch (default no-op beyond recording)."""
        self.phase = phase

    def trainable_predicate(self, phase: str):
        """Returns f(param_name) -> bool: whether a top-level parameter is
        trainable in this phase. Default: everything trainable."""
        return lambda name: True

    def sparse_spec(self, phase: str):
        """Optional row-sparse optimizer support (``phase_optimizer: sparse``):
        ``{param_name: [batch_key, ...]}`` mapping each embedding table to the
        batch fields whose ids index it in this phase's loss. Declaring a
        table asserts that the loss reads it ONLY through those ids; the
        training step then differentiates with respect to the gathered rows
        and updates only touched rows. ``None`` (default): unsupported, the
        phase falls back to the dense update."""
        return None

    # -- contract -----------------------------------------------------------

    def loss_fn(self, phase: str):
        """Returns ``batch -> scalar loss`` for the phase."""
        raise NotImplementedError

    def forward(self, batch, phase: str):
        """The phase's loss on ``batch``; lets ``torch.func.functional_call``
        run the loss with some parameters replaced (the sparse step's
        gathered sub-tables)."""
        return self.loss_fn(phase)(batch)

    def full_sort(self, users: torch.Tensor, phase: str = "TARGET") -> torch.Tensor:
        """``users [B] -> scores [B, item_space]``; target phases score the
        contiguous target prefix ``[0, target_num_items)``."""
        raise NotImplementedError

    def full_sort_factors(self, phase: str = "TARGET"):
        """Optional: ``users [B] -> (user_repr [B, D], item_repr
        [item_space, D])`` for models whose full-sort score is a plain dot
        product. Enables the streaming top-k evaluator for large item spaces
        without materializing [B, items] scores. ``None`` (default): the
        model has no such form."""
        return None
