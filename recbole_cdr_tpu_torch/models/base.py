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

import contextlib
from typing import Sequence

import torch
from torch import nn

from recbole_cdr_tpu_torch.parallel.embedding import sharded_lookup
from recbole_cdr_tpu_torch.utils.enums import ModelType


# ----------------------------------------------------------------- init utils

def xavier_normal(shape, generator=None, dtype=torch.float32) -> torch.Tensor:
    """Xavier/Glorot normal over the trailing two dims: std = sqrt(2/(d0+d1))."""
    fan_sum = shape[0] + shape[1] if len(shape) >= 2 else shape[0] * 2
    std = (2.0 / fan_sum) ** 0.5
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def init_embedding(num, dim, generator=None, dtype=torch.float32) -> torch.Tensor:
    return xavier_normal((num, dim), generator, dtype)


class Linear(nn.Module):
    """``x @ w + b`` in the JAX package's layout, ``w`` [d_in, d_out] and
    ``b`` [d_out] (``init_linear``, `models/base.py:40-46`): xavier-normal
    weight, zero bias. The orientation is JAX's, not ``nn.Linear``'s, so
    that weights carry over without a transpose. An input of another
    floating type than the weights' is promoted as JAX promotes ``x @ w +
    b``: float32 inputs on 16-bit copies of the weights (DMF's towers under
    ``compute_dtype: bfloat16``) compute in float32 on the exactly upcast
    weights."""

    def __init__(self, d_in, d_out, generator=None, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(xavier_normal((d_in, d_out), generator, dtype))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype))

    def forward(self, x):
        w, b = self.w, self.b
        if x.dtype != w.dtype:
            dtype = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        return x @ w + b


def mlp(dims, generator=None) -> nn.ModuleList:
    """``init_mlp`` (`models/base.py:49-54`): one :class:`Linear` per
    consecutive pair of ``dims``, named ``0``, ``1``, ... as JAX's list."""
    return nn.ModuleList(Linear(dims[i], dims[i + 1], generator) for i in range(len(dims) - 1))


# -------------------------------------------------------------------- losses

def weighted_sums(values: torch.Tensor, weight: torch.Tensor):
    """(sum(v*w), sum(w)) in float32: the batch sums of :func:`weighted_mean`."""
    values = values.float()
    weight = weight.float()
    return torch.sum(values * weight), torch.sum(weight)


def weighted_mean(values: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mean over real (unpadded) samples: sum(v*w)/sum(w), in float32."""
    num, den = weighted_sums(values, weight)
    return num / torch.clamp(den, min=1.0)


def bce_terms(logits, labels) -> torch.Tensor:
    """Per-sample binary cross-entropy on logits (== BCELoss(sigmoid(x), y),
    stable)."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def bce_loss(logits, labels, weight) -> torch.Tensor:
    """Binary cross-entropy on logits, weighted mean over the batch."""
    return weighted_mean(bce_terms(logits, labels), weight)


def bpr_terms(pos_score, neg_score, gamma: float = 1e-10) -> torch.Tensor:
    """Per-sample -log(gamma + sigmoid(pos - neg)): recbole ``BPRLoss``'s
    terms, whose weighted mean is the loss
    (``CrossDomainRecommender.batch_mean``)."""
    return -torch.log(gamma + torch.sigmoid(pos_score - neg_score))


def emb_sums(embeddings: Sequence[torch.Tensor], weight, norm: int = 2):
    """sum(|E_i * w|^p) of each table's rows: the batch sums of
    :func:`emb_loss`."""
    weight = weight.float()
    out = []
    for e in embeddings:
        w = weight.reshape((-1,) + (1,) * (e.dim() - 1))
        out.append(torch.sum(torch.abs(e.float() * w) ** norm))
    return out


def domain_sums(terms, weight, embeddings=None) -> list:
    """The batch sums of a domain's loss: (sum(terms * w), sum(w)), then, where
    ``embeddings`` are given, EmbLoss's squared norm of each (``emb_sums``)."""
    return list(weighted_sums(terms, weight)) + (emb_sums(embeddings, weight)
                                                  if embeddings else [])


def domain_loss(sums, coef) -> torch.Tensor:
    """The loss from :func:`domain_sums`' values (summed over the global batch
    under a mesh): the weighted mean of the terms, plus ``coef`` times
    EmbLoss where the sums hold its norms."""
    den = torch.clamp(sums[1], min=1.0)
    loss = sums[0] / den
    if len(sums) > 2:
        loss = loss + coef * (sum(s ** 0.5 for s in sums[2:]) / den)
    return loss


def emb_loss(embeddings: Sequence[torch.Tensor], weight, norm: int = 2,
             require_pow: bool = False) -> torch.Tensor:
    """recbole ``EmbLoss``: sum_i ||E_i||_p [/ p if require_pow] / batch_size,
    restricted to real (unpadded) rows via ``weight``."""
    denom = torch.clamp(torch.sum(weight.float()), min=1.0)
    total = 0.0
    for s in emb_sums(embeddings, weight, norm):
        total = total + (s / norm if require_pow else s ** (1.0 / norm))
    return total / denom


def reg_loss(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """recbole ``RegLoss``: sum of the L2 norms of whole parameter tensors."""
    total = 0.0
    for w in weights:
        w = w.float()
        total = total + torch.sqrt(torch.sum(w * w))
    return total


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
        #: generation counter of the parameters, for caches of values derived
        #: from them (BiTGCF's propagated tables, NATR's anchor table): the
        #: training step bumps it after every optimizer step,
        #: ``load_state_dict`` after every load
        self.params_version = 0
        #: name -> (params_version, value), kept by :meth:`_per_version`
        self._version_cache = {}

    def _overlap_mode(self, model: str) -> str:
        """The mapping models' mode (DCDCSR, EMCDR, SSCDR): the pair must
        overlap on users or on items, not both."""
        assert self.overlapped_num_items == 1 or self.overlapped_num_users == 1, (
            f"{model} model only support user overlapped or item overlapped dataset! "
        )
        if self.overlapped_num_users > 1:
            return "overlap_users"
        return "overlap_items" if self.overlapped_num_items > 1 else "non_overlap"

    def _domain_tables(self, d_source: int, d_target: int, generator) -> None:
        """The mapping models' four embedding tables over the unified id
        space, each domain's rows outside it zeroed (reference
        `emcdr.py:73-78`): ``source_user_embedding`` [users, d_source] and
        the like."""
        for name, n, dim, lo, hi in (
                ("source_user_embedding", self.total_num_users, d_source,
                 self.overlapped_num_users, self.target_num_users),
                ("source_item_embedding", self.total_num_items, d_source,
                 self.overlapped_num_items, self.target_num_items),
                ("target_user_embedding", self.total_num_users, d_target,
                 self.target_num_users, self.total_num_users),
                ("target_item_embedding", self.total_num_items, d_target,
                 self.target_num_items, self.total_num_items)):
            table = init_embedding(n, dim, generator)
            table[lo:hi] = 0.0
            setattr(self, name, nn.Parameter(table))

    # -- the mesh -------------------------------------------------------------

    #: the (data, model) mesh the model trains over and the row shards of its
    #: tables, ``{name: TableShard}`` (``parallel/mesh.py::shard_params``);
    #: None and empty off the mesh
    mesh = None
    table_shards = {}
    #: whether the model trains and evaluates under ``mesh_shape`` (ROADMAP.md
    #: A13 remainder: CMF, EMCDR and DCDCSR so far)
    MESH_READY = False

    def rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of table ``name`` (a parameter or a buffer): a
        gather, or for a row-sharded table the lookup over the model group
        (``parallel/embedding.py``). The gather is ``F.embedding``, as in
        the training gathers of every model but DeepAPF, which has none
        (kernel B16 reads its tables by id and writes their gradients
        itself): its backward adds a row's gradient rows in an order the ids
        fix, on the CPU (where the index gather's backward adds them by
        atomic adds over threads, in an order that changes from run to
        run) and on the card."""
        table = getattr(self, name)
        shard = self.table_shards.get(name)
        if shard is None:
            return nn.functional.embedding(ids.long(), table)
        return sharded_lookup(table, ids, shard.offset, self.mesh.model_group)

    def pair_rows(self, user_name: str, item_name: str, user, item):
        """K1's operands for the pairs (user, item) of two tables: the tables
        and the int32 ids, or, where either table is row-sharded, the rows
        the lookup gathered and each pair's position in them; last, which
        tables the pairs read by position (``gather_dot``'s ``positions``):
        gathered rows, and the sparse step's sub-tables (:meth:`sub_tables`),
        whose row r is the step's r-th occurrence."""
        if user_name not in self.table_shards and item_name not in self.table_shards:
            return (getattr(self, user_name), getattr(self, item_name),
                    user.to(torch.int32), item.to(torch.int32),
                    (user_name in self.sub_table_names, item_name in self.sub_table_names))
        pos = torch.arange(user.shape[0], dtype=torch.int32, device=user.device)
        return self.rows(user_name, user), self.rows(item_name, item), pos, pos, (True, True)

    #: the tables the sparse step has substituted by sub-tables (:meth:`sub_tables`)
    sub_table_names = frozenset()

    @contextlib.contextmanager
    def sub_tables(self, names):
        """Within the block, the tables ``names`` are the sparse step's [R, D]
        sub-tables of the step's occurrences (gathered once, through the
        lookup for a row-sharded table), which the batch's re-based ids index
        by position: :meth:`rows` indexes each directly, not at a shard's
        offset, and :meth:`pair_rows` marks it read by position."""
        saved = self.table_shards, self.sub_table_names
        self.table_shards = {n: s for n, s in saved[0].items() if n not in names}
        self.sub_table_names = frozenset(names)
        try:
            yield
        finally:
            self.table_shards, self.sub_table_names = saved

    def table_columns(self, name: str, n: int):
        """(this rank's rows of ``table[:n]``, their first global row): the
        whole prefix and 0 off the model axis."""
        table = getattr(self, name)
        shard = self.table_shards.get(name)
        if shard is None:
            return table[:n], 0
        return table[:max(0, min(table.shape[0], n - shard.offset))], shard.offset

    def full_table(self, name: str) -> torch.Tensor:
        """Table ``name`` whole: a row-sharded one gathered over the model
        group, once per parameter version and type (the dense evaluation's
        scores, a 16-bit compute's cast copy apart from the float32 one)."""
        table = getattr(self, name)
        shard = self.table_shards.get(name)
        if shard is None:
            return table
        return self._per_version(f"full:{name}:{table.dtype}",
                                 lambda: self.mesh.gather_rows(table.detach())[:shard.rows])

    def whole_items(self, side):
        """The whole item side of a full-sort score: ``side`` is ``(table, n)``,
        the first n rows of a table (gathered over the model group when it is
        row-sharded), or a block every rank holds whole (built from gathered
        tables, or a replicated buffer), returned as it is."""
        if isinstance(side, tuple):
            name, n = side
            return self.full_table(name)[:n]
        return side

    def item_factors(self, user_e, side):
        """Streaming factors against ``side`` (as :meth:`whole_items`):
        ``(user_e, items)``, and under a mesh ``(user_e, this rank's rows of
        them, their first row)`` (B14's operands): a table prefix's rows that
        the shard holds, or this model rank's contiguous share of a block, so
        that B14's merge sees each item once."""
        if self.mesh is None:
            return user_e, self.whole_items(side)
        if isinstance(side, tuple):
            return (user_e, *self.table_columns(*side))
        per = -(-side.shape[0] // self.mesh.model)
        lo = min(self.mesh.model_index * per, side.shape[0])
        return user_e, side[lo:lo + per], lo

    def batch_sums(self, *sums: torch.Tensor):
        """A loss's batch sums over the whole global batch: as they are off
        the mesh, summed over the data group under it (each rank's gradient
        is then its slice's part of the global batch's)."""
        if self.mesh is None:
            return sums
        return tuple(self.mesh.batch_sum(torch.stack(sums)).unbind())

    def batch_mean(self, values, weight) -> torch.Tensor:
        """:func:`weighted_mean` over the global batch (its sums through
        :meth:`batch_sums`)."""
        num, den = self.batch_sums(*weighted_sums(values, weight))
        return num / torch.clamp(den, min=1.0)

    def notify_params_updated(self):
        """Invalidate caches derived from the parameters."""
        self.params_version += 1

    def _per_version(self, name: str, build):
        """``build()``'s value, computed once per parameter version and kept
        under ``name``; a stale value is freed before its rebuild."""
        hit = self._version_cache.get(name)
        if hit is None or hit[0] != self.params_version:
            self._version_cache.pop(name, None)
            self._version_cache[name] = hit = (self.params_version, build())
        return hit[1]

    def load_state_dict(self, state_dict, *args, **kwargs):
        """``nn.Module.load_state_dict``, after which every cache derived from
        the parameters is stale. A buffer of ``state_dict`` whose shape
        differs from the module's is taken at its new shape: derived tables
        (DCDCSR's benchmark and affine embeddings) change shape on phase
        entry, and a snapshot taken after that must load into a module
        still holding the placeholder, and the other way round."""
        for name, buf in list(self.named_buffers()):
            value = state_dict.get(name)
            if value is not None and value.shape != buf.shape:
                owner, _, leaf = name.rpartition(".")
                module = self.get_submodule(owner) if owner else self
                module._buffers[leaf] = torch.empty(value.shape, dtype=buf.dtype,
                                                    device=buf.device)
        out = super().load_state_dict(state_dict, *args, **kwargs)
        self.notify_params_updated()
        return out

    # -- phase machinery ----------------------------------------------------

    def set_phase(self, phase: str):
        """Host-side phase switch (default no-op beyond recording)."""
        self.phase = phase

    def mutate_params_on_phase(self, phase: str):
        """Parameter surgery on phase entry, in place (DCDCSR builds its
        benchmark and affine tables here); a model that writes a table calls
        :meth:`notify_params_updated`. Default: nothing."""

    def needs_host_augment(self, phase: str) -> bool:
        """True when the phase needs :meth:`augment_batch` on the host: the
        trainer then trains it on the host batch path, not the device epoch
        loop."""
        return False

    def augment_batch(self, batch: dict, phase: str) -> dict:
        """Host-side batch augmentation before the batch moves to the device
        (SSCDR's neighbour sampling, DCDCSR's map-batch draw). Default:
        the batch unchanged."""
        return batch

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
        """Returns ``(batch, rng=None) -> scalar loss`` for the phase. ``rng``
        is the step's draw of random bits, ``rng(layer, domain, shape) ->
        int32 bits`` (the epoch loop binds the random source's
        ``dropout_bits`` to the epoch and step); models without training
        noise ignore it, and None trains without noise."""
        raise NotImplementedError

    def forward(self, batch, phase: str, rng=None):
        """The phase's loss on ``batch``; lets ``torch.func.functional_call``
        run the loss with some parameters replaced (the sparse step's
        gathered sub-tables)."""
        return self.loss_fn(phase)(batch, rng)

    def predict(self, batch) -> torch.Tensor:
        """Scores of the target (user, item) pairs of ``batch`` in the
        current phase (``predict_fn``, `models/base.py:232-234`)."""
        raise NotImplementedError

    #: the default predict_grid's max items and max (user, item) pairs of one
    #: chunk (``recbole_cdr_tpu/trainer/trainer.py:337-385``)
    MAX_CHUNK, PAIR_BUDGET = 4096, 1 << 18

    def predict_grid(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Scores of every (user, item) pair of ``users [B]`` x ``items [I]``,
        as [B, I]: the predict fallback's hook (``trainer.
        make_predict_full_sort``). The default scores the grid as the JAX
        fallback's scan does: the item axis cut into chunks of at most
        ``MAX_CHUNK`` items and ``PAIR_BUDGET`` pairs, the tail chunk clamped
        onto the last item, each chunk flattened into pairs for
        :meth:`predict`, and the duplicate columns sliced off. A model whose
        scores share per-user or per-item work overrides it to score the
        whole grid in one call."""
        B, n = users.shape[0], items.shape[0]
        chunk = min(self.MAX_CHUNK, max(128, self.PAIR_BUDGET // max(B, 1)),
                    max(128, 1 << (n - 1).bit_length()))
        n_chunks = -(-n // chunk)
        pos = torch.clamp(torch.arange(n_chunks * chunk, device=items.device), max=n - 1)
        tiles = []
        for cols in items[pos].reshape(n_chunks, chunk):
            batch = {self.TARGET_USER_ID: users.repeat_interleave(chunk),
                     self.TARGET_ITEM_ID: cols.repeat(B)}
            tiles.append(self.predict(batch).reshape(B, chunk))
        return torch.cat(tiles, 1)[:, :n]

    def full_sort(self, users: torch.Tensor, phase: str = "TARGET") -> torch.Tensor:
        """``users [B] -> scores [B, item_space]``; target phases score the
        contiguous target prefix ``[0, target_num_items)``."""
        raise NotImplementedError

    def full_sort_fn(self, phase: str = "TARGET"):
        """``users [B] -> scores [B, item_space]`` for the phase, or None
        when the model has no full-sort form there: the trainer then scores
        through :meth:`predict_grid` (``trainer.make_predict_full_sort``),
        as the JAX trainer's ``_score_fn_for`` does."""
        return lambda users: self.full_sort(users, phase)

    def full_sort_factors(self, phase: str = "TARGET"):
        """Optional: ``users [B] -> (user_repr [B, D], item_repr
        [item_space, D])`` for models whose full-sort score is a plain dot
        product. Enables the streaming top-k evaluator for large item spaces
        without materializing [B, items] scores. ``None`` (default): the
        model has no such form."""
        return None
