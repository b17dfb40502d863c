"""Device-resident epoch execution: the training hot path.

Port of ``recbole_cdr_tpu/trainer/device_loop.py``. The interaction arrays,
per-user history matrix and candidate-id runs live on the device; per epoch
the loop builds every step's batch IN BULK (the epoch shuffle through kernel
K3, ``ops/shuffle.py``; the negatives through kernel K2,
``ops/neg_sampler.py``), in segments bounded by ``SEGMENT_BYTES``, then a
Python loop walks the per-step slices through the trainer's step function
(loss -> backward -> optimizer step; for ``phase_optimizer: sparse`` the
step first re-bases the batch onto gathered sub-tables with
:func:`rebase_sparse_batch`).

All randomness comes from a *random source* (:class:`TorchRandomSource` by
default, drawing from a ``torch.Generator`` on the training device): the
swap-or-not keys and salts per domain (one set per source cycle in a BOTH
phase), the uint32 base bits of each segment's negatives, and the per-step
dropout bits a model's loss asks for. The JAX package draws the same
quantities from threefry keys it derives per epoch, segment and step, so a
test can hand its bits to this loop through the same interface.

The loop runs the BOTH, SOURCE and TARGET phases of a pointwise or a
pairwise model (CMF's and BiTGCF's BOTH schedule, NATR's SOURCE then
TARGET, the BPR and triplet phases of DCDCSR, EMCDR and SSCDR), and the
OVERLAP phase (EMCDR's mapping). A single-domain phase streams that domain
alone, with one un-cycled permutation per epoch; a pairwise batch carries
its negatives in a ``neg_<item id>`` column and no label; the OVERLAP
stream serves the overlapped entities' ids, shuffled by K3, in batches of
``overlap_batch_size`` with a validity weight. Popularity-distribution
negatives (``neg_sampling: {popularity: N}``) go through kernel B2a
(``ops/neg_sampler.py::sample_negatives_popularity``) over the sampler's
alias table, with their acceptance stream from the random source's
``accept_bits``.

Under a (data, model) mesh (``parallel/mesh.py``) every rank draws the
GLOBAL epoch stream from the same seed (the K3 shuffle, the K2 or B2a
negatives, the dropout bits) and trains on its ``data`` slice of each
step's columns: the JAX loop's ``P(None, "data")`` constraint
(``recbole_cdr_tpu/trainer/device_loop.py:400-416``), which keeps the
random stream of one device.
"""

import functools

import numpy as np
import torch

from recbole_cdr_tpu_torch.parallel.distributed import put_sharded
from recbole_cdr_tpu_torch.ops.hashing import as_u32
from recbole_cdr_tpu_torch.ops.neg_sampler import (
    sample_negatives,
    sample_negatives_popularity,
)
from recbole_cdr_tpu_torch.ops.shuffle import SHUFFLE_ROUNDS, swap_or_not
from recbole_cdr_tpu_torch.utils.enums import InputType, TrainMode

#: per-epoch batch-stream memory budget; epochs whose streams exceed it are
#: built and consumed in segments
SEGMENT_BYTES = 256 << 20

#: width cap of the membership matrix [num_users, H]; users above it
#: ("heavy") draw their negatives from an exact complement list instead
HIST_WIDTH_CAP = 2048

#: budget (int32 elements) for the materialized heavy-user complement lists
COMPLEMENT_BUDGET = 64 << 20


def _device_hist(used, num_users: int, cap: int = None):
    """Padded per-user history matrix [U, H] from a sampler's UsedIds,
    H <= ``cap``. Padding uses the sentinel ``num_items`` (never equals a
    candidate id). Returns (hist, heavy_uids, lens) — heavy users' rows hold
    only their first ``cap`` items and MUST be overridden by the complement
    path; ``lens`` int32 [U] is each row's count of items, clipped to H: a
    row's items are its first ``lens[u]`` entries, in ascending item order,
    and the rest of it is padding."""
    cap = HIST_WIDTH_CAP if cap is None else cap
    keys = used.keys
    uids = (keys // used.num_items).astype(np.int64)
    iids = (keys % used.num_items).astype(np.int64)
    counts = np.bincount(uids, minlength=num_users)
    full_H = max(int(counts.max()) if len(counts) else 1, 1)
    H = min(full_H, cap)
    heavy_uids = np.flatnonzero(counts > cap)
    hist = np.full((num_users, H), used.num_items, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos_in = np.arange(len(uids)) - starts[uids]
    keep = pos_in < H
    hist[uids[keep], pos_in[keep]] = iids[keep]
    return hist, heavy_uids, np.minimum(counts[:num_users], H).astype(np.int32)


def _heavy_complements(used, heavy_uids, candidate_ids, num_users: int):
    """Exact per-heavy-user complement lists for uniform negative sampling:
    (heavy_idx [num_users] int32 — -1 for light users, else the user's slot;
    offsets [n_heavy+1]; lens [n_heavy]; concat [sum]) where
    ``concat[offsets[i] : offsets[i] + lens[i]]`` are the candidate ids user
    ``heavy_uids[i]`` has NOT interacted with. A degenerate user who covered
    every candidate gets a 1-slot list."""
    keys = np.sort(used.keys)
    uids = (keys // used.num_items).astype(np.int64)
    iids = (keys % used.num_items).astype(np.int64)
    heavy_idx = np.full(num_users, -1, np.int32)
    heavy_idx[heavy_uids] = np.arange(len(heavy_uids), dtype=np.int32)
    comps = []
    for u in heavy_uids:
        lo = np.searchsorted(uids, u)
        hi = np.searchsorted(uids, u + 1)
        comp = np.setdiff1d(candidate_ids, iids[lo:hi])
        if len(comp) == 0:
            comp = candidate_ids[:1]
        comps.append(comp.astype(np.int32))
    lens = np.array([len(c) for c in comps], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    concat = (
        np.concatenate(comps).astype(np.int32) if comps
        else np.zeros(1, np.int32)
    )
    return heavy_idx, offsets, lens, concat


def _contiguous_ranges(ids: np.ndarray, max_ranges: int = 2):
    """Describe an id array as a tuple of (start, length) runs, or None if it
    needs more than ``max_ranges``. The sectioned ID space makes every
    candidate list at most two runs (overlap prefix ++ domain-only suffix)."""
    ids = np.asarray(ids)
    if len(ids) == 0:
        return ((0, 0),)
    breaks = np.flatnonzero(np.diff(ids) != 1)
    if len(breaks) + 1 > max_ranges:
        return None
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [len(ids)]])
    return tuple((int(ids[s]), int(e - s)) for s, e in zip(starts, ends))


def rebase_sparse_batch(batch, spec):
    """Re-base a batch onto the gathered rows of each table of ``spec``
    (``{table: [batch_key, ...]}``, ``model.sparse_spec``): every occurrence
    of a batch id becomes its own row of an [R, D] sub-table, and the batch's
    id fields are remapped to positions ``0..R-1``. Returns (the remapped
    batch, ``{table: int32 [R] ids}``). A key that indexes several tables
    must sit at the same offset in each of their concatenations.

    Port of the sparse step body of ``recbole_cdr_tpu/trainer/
    device_loop.py:619-648``."""
    batch2 = dict(batch)
    idx = {}
    key_offset = {}
    for name, keys in spec.items():
        parts, off = [], 0
        for k in keys:
            a = batch[k].reshape(-1)
            if key_offset.setdefault(k, off) != off:
                raise ValueError(
                    f"sparse_spec: batch key {k!r} sits at offsets {key_offset[k]} and "
                    f"{off} in different tables' index concats; reorder the spec so "
                    "shared keys align"
                )
            batch2[k] = (off + torch.arange(a.shape[0], dtype=a.dtype, device=a.device)
                         ).reshape(batch[k].shape)
            parts.append(a.to(torch.int32))
            off += a.shape[0]
        idx[name] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return batch2, idx


class TorchRandomSource:
    """Default random source: every draw comes from one ``torch.Generator``
    on the training device, in the order the epoch loop asks.

    A random source answers five requests; the (epoch, domain, step_lo or
    step, layer) arguments name the draw so that a source can derive it
    statelessly (the JAX package's threefry keys are derived that way)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _bits(self, shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=self.device, generator=self.gen)

    def shuffle_keys(self, epoch: int, domain: str, n: int, shape=()):
        """(keys int32 in [0, n), salts int32 bit patterns), each
        ``shape + (SHUFFLE_ROUNDS,)``; ``domain`` is ``"src"``, ``"tgt"`` or
        ``"over"`` (the OVERLAP stream)."""
        shape = tuple(shape) + (SHUFFLE_ROUNDS,)
        keys = torch.randint(0, max(n, 1), shape, dtype=torch.int32,
                             device=self.device, generator=self.gen)
        return keys, self._bits(shape)

    def negative_bits(self, epoch: int, domain: str, step_lo: int, total: int):
        """int32 bit patterns of one uint32 base per negative slot."""
        return self._bits((total,))

    def accept_bits(self, epoch: int, domain: str, step_lo: int, total: int):
        """int32 bit patterns of one uint32 per slot for the popularity
        draw's acceptance stream (JAX ``fold_in(rng, 1)``)."""
        return self._bits((total,))

    def heavy_bits(self, epoch: int, domain: str, step_lo: int, total: int):
        """int32 bit patterns of one uint32 per slot for the heavy-user draw."""
        return self._bits((total,))

    def dropout_bits(self, epoch: int, step: int, layer: int, domain: str, shape):
        """int32 bit patterns of one uint32 per element of a model's training
        dropout mask (BiTGCF: per graph layer and domain, drawn only when
        the model asks)."""
        return self._bits(tuple(shape))


class DomainDeviceData:
    """One domain's device-resident training data."""

    def __init__(self, table, sampler, num_users: int, device):
        put = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        self.uid = put(table[table.uid_field])
        self.iid = put(table[table.iid_field])
        self.n = len(table)
        self.uid_field = table.uid_field
        self.iid_field = table.iid_field
        self.label_field = table.label_field
        self.neg_iid_field = table.neg_prefix + table.iid_field
        self.weight_field = table.uid_field.split("_", 1)[0] + "_sample_weight"
        popularity = getattr(sampler, "distribution", "uniform") == "popularity"
        if popularity:
            # no complement-uniform equivalent: the membership matrix stays
            # full-width (the rejection must see every item), as in JAX, so
            # no user is heavy
            cap = 1 << 30
        else:
            # raise the cap until the worst-case complement total fits the budget
            n_cand = len(sampler.candidate_ids)
            counts = np.bincount(
                (sampler.used.keys // sampler.used.num_items).astype(np.int64),
                minlength=num_users,
            )
            max_deg = int(counts.max()) if len(counts) else 0
            cap = HIST_WIDTH_CAP
            while cap < max_deg and int((counts > cap).sum()) * n_cand > COMPLEMENT_BUDGET:
                cap *= 2
        hist_np, heavy_uids, lens = _device_hist(sampler.used, num_users, cap)
        self.hist = put(hist_np)
        # each row's live entries, so that the sampler walks no padding
        self.lens = put(lens)
        self.heavy = None
        if len(heavy_uids):
            self.heavy = tuple(put(a) for a in _heavy_complements(
                sampler.used, heavy_uids, np.asarray(sampler.candidate_ids), num_users,
            ))
        # the popularity draw's alias table (values, prob, alias) on the
        # device (JAX :378-387); the uniform draw's candidate runs
        self.alias = None
        self.cand_ranges = _contiguous_ranges(sampler.candidate_ids)
        if popularity:
            at = sampler._alias
            self.alias = (put(at.values),
                          torch.as_tensor(np.asarray(at.prob, np.float32), device=device),
                          put(at.alias))
        elif self.cand_ranges is None:
            raise NotImplementedError(
                "candidate lists of more than two contiguous id runs are not "
                "ported (the sectioned ID space never produces them)"
            )


class DeviceEpochLoop:
    """Runs whole epochs of BOTH-, SOURCE-, TARGET- or OVERLAP-phase train
    steps on the device.

    ``step_fn(batch, rng) -> loss`` performs one optimizer step on a dict of
    per-step tensors (the layout ``data/batching.py`` produces) and returns
    the step's loss as a device scalar; ``rng(layer, domain, shape)`` is the
    random source's ``dropout_bits`` bound to the epoch and the step's index
    within it (JAX's ``loss_fn(params, batch, fold_in(epoch_rng, step))``)."""

    def __init__(self, scheme: TrainMode, step_fn, train_data, input_type,
                 neg_num: int, num_users: int, random_source, device, mesh=None):
        if input_type not in (InputType.POINTWISE, InputType.PAIRWISE):
            raise NotImplementedError(
                f"the device epoch loop streams pointwise and pairwise batches, not "
                f"{input_type.name}"
            )
        self.scheme = scheme
        self.step_fn = step_fn
        self.source = random_source
        self.device = torch.device(device)
        self.neg_num = neg_num
        self.mesh = mesh
        self.pointwise = input_type == InputType.POINTWISE
        src_b = train_data.source_batcher
        tgt_b = train_data.target_batcher
        over_b = train_data.overlap_batcher
        # only the data the phase streams lives on the device
        self.src = self.tgt = self.overlap_ids = None
        if scheme in (TrainMode.BOTH, TrainMode.SOURCE):
            self.src = DomainDeviceData(src_b.table, src_b.sampler, num_users, self.device)
        if scheme in (TrainMode.BOTH, TrainMode.TARGET):
            self.tgt = DomainDeviceData(tgt_b.table, tgt_b.sampler, num_users, self.device)
        per_example = (1 + neg_num) if self.pointwise else 1
        if scheme == TrainMode.OVERLAP:
            self.overlap_ids = torch.as_tensor(np.asarray(over_b.overlap.ids, np.int32),
                                               device=self.device)
            self.n_over = len(over_b.overlap)
            self.step = over_b.step
            self.steps_per_epoch = max(1, -(-self.n_over // self.step))
            per_example = 1
        elif scheme == TrainMode.SOURCE:
            self.step = src_b.step
            self.steps_per_epoch = len(src_b)
        else:
            self.step = tgt_b.step
            self.steps_per_epoch = len(tgt_b)
        ex_per_step = self.step
        if scheme == TrainMode.BOTH:
            self.src_step = src_b.step
            ex_per_step += self.src_step
            # each source cycle of an epoch gets its own permutation
            # (`data/batching.py` reshuffles the source on exhaustion)
            self.src_batches_per_cycle = max(1, -(-self.src.n // self.src_step))
            self.src_cycles = max(1, -(-self.steps_per_epoch // self.src_batches_per_cycle))

        # ---- segment sizing: bound the per-epoch streams in device memory --
        self.examples_per_step = ex_per_step * per_example
        bytes_per_step = max(self.examples_per_step, 1) * 4 * 4  # ~4 int/float arrays
        self.seg_steps = max(1, min(self.steps_per_epoch, SEGMENT_BYTES // bytes_per_step))

    # ------------------------------------------------------------ streams

    def _domain_stream(self, data, domain, shuf, step_lo, n_steps, dstep,
                       cycle, epoch):
        """Bulk [n_steps, dstep] uid/iid/weight + [neg, n_steps, dstep]
        negatives for steps [step_lo, step_lo + n_steps)."""
        keys, salts = shuf                                  # [K, ROUNDS]
        s = step_lo + torch.arange(n_steps, device=self.device)
        cols = torch.arange(dstep, device=self.device)
        if cycle:
            c = s // self.src_batches_per_cycle
            local = s % self.src_batches_per_cycle
            slots = local[:, None] * dstep + cols[None, :]
            keys, salts = keys[c], salts[c]                 # one permutation per cycle
        else:
            slots = s[:, None] * dstep + cols[None, :]
        valid = slots < data.n
        rows = swap_or_not(
            (torch.where(valid, slots, 0) % max(data.n, 1)).to(torch.int32), data.n, keys, salts,
        ).long()
        uid = data.uid[rows]
        iid = data.iid[rows]
        weight = valid.to(torch.float32)
        if self.neg_num > 0:
            total = n_steps * dstep * self.neg_num
            flat_uid = uid.reshape(-1)
            base = self.source.negative_bits(epoch, domain, step_lo, total)
            if data.alias is not None:
                neg = sample_negatives_popularity(
                    base, self.source.accept_bits(epoch, domain, step_lo, total),
                    flat_uid, data.hist, data.alias, self.neg_num, data.lens,
                )
            else:
                neg = sample_negatives(base, flat_uid, data.hist, data.cand_ranges,
                                       self.neg_num, data.lens)
            if data.heavy is not None:
                neg = self._heavy_override(data, domain, flat_uid, neg, epoch, step_lo)
            neg = neg.reshape(self.neg_num, n_steps, dstep)
        else:
            neg = torch.zeros((0, n_steps, dstep), dtype=torch.int32, device=self.device)
        return uid, iid, weight, neg

    def _heavy_override(self, data, domain, flat_uid, neg, epoch, step_lo):
        """Heavy-tail users' rows are truncated, so their rejection result is
        replaced by a uniform draw from their exact complement list (uniform
        under popularity sampling too, as in JAX :309-322; the loop's
        full-width popularity history has no heavy user)."""
        heavy_idx, offs, lens, concat = data.heavy
        h = heavy_idx[flat_uid.long().repeat(self.neg_num)]
        is_h = h >= 0
        hs = torch.where(is_h, h, 0).long()
        L = torch.clamp(lens[hs], min=1).to(torch.int64)
        rbits = as_u32(self.source.heavy_bits(epoch, domain, step_lo, neg.shape[0]))
        r = rbits % L
        return torch.where(is_h, concat[(offs[hs] + r).long()], neg)

    def _domain_xs(self, data, uid, iid, weight, neg):
        """Per-step batch arrays in the layout TrainBatcher produces
        (`data/batching.py`), stacked over steps. Pointwise: ``dstep``
        positives, then ``neg_num`` blocks of negatives, labels 1 then 0.
        Pairwise: the positives with their negatives in the ``neg_<item
        id>`` column, ``neg_num`` blocks of ``dstep``, and no label."""
        n_steps, dstep = uid.shape
        neg_num = self.neg_num
        negf = neg.permute(1, 0, 2).reshape(n_steps, neg_num * dstep)
        if not self.pointwise:
            out = {data.uid_field: uid, data.iid_field: iid, data.weight_field: weight}
            if neg_num > 0:
                out[data.neg_iid_field] = negf
            return out
        label = torch.zeros(dstep * (1 + neg_num), device=self.device)
        label[:dstep] = 1.0
        return {
            data.uid_field: torch.cat([uid] * (1 + neg_num), dim=1),
            data.iid_field: torch.cat([iid, negf], dim=1),
            data.weight_field: torch.cat([weight] * (1 + neg_num), dim=1),
            data.label_field: label.expand(n_steps, -1),
        }

    def _overlap_xs(self, shuf, step_lo, n_steps):
        """The OVERLAP stream of steps [step_lo, step_lo + n_steps): every
        step's ``overlap_batch_size`` slots of one K3 permutation of the
        overlapped ids, the slots past the end weighted 0
        (``recbole_cdr_tpu/trainer/device_loop.py:560-570``)."""
        keys, salts = shuf
        s = step_lo + torch.arange(n_steps, device=self.device)
        slots = s[:, None] * self.step + torch.arange(self.step, device=self.device)[None, :]
        valid = slots < self.n_over
        n = max(self.n_over, 1)
        pos = swap_or_not((torch.where(valid, slots, 0) % n).to(torch.int32), n, keys, salts)
        return {"overlap": self.overlap_ids[pos.long()],
                "overlap_sample_weight": valid.to(torch.float32)}

    def _build_xs(self, shuf, epoch, step_lo, n_steps):
        """Every step's batch of steps [step_lo, step_lo + n_steps): both
        domains in a BOTH phase (the source cycling, with its own step),
        else the phase's domain, or the OVERLAP stream, alone at the phase's
        step."""
        xs = {}
        if self.scheme == TrainMode.BOTH:
            xs.update(self._domain_xs(self.src, *self._domain_stream(
                self.src, "src", shuf["src"], step_lo, n_steps, self.src_step, True, epoch)))
        elif self.scheme == TrainMode.SOURCE:
            xs.update(self._domain_xs(self.src, *self._domain_stream(
                self.src, "src", shuf["src"], step_lo, n_steps, self.step, False, epoch)))
        elif self.scheme == TrainMode.OVERLAP:
            xs.update(self._overlap_xs(shuf["over"], step_lo, n_steps))
        if self.tgt is not None:
            xs.update(self._domain_xs(self.tgt, *self._domain_stream(
                self.tgt, "tgt", shuf["tgt"], step_lo, n_steps, self.step, False, epoch)))
        return xs

    # -------------------------------------------------------------- epochs

    def _shuffle_material(self, epoch):
        """This epoch's swap-or-not keys and salts, [K, ROUNDS] per stream:
        in a BOTH phase one permutation per source cycle and one for the
        target, else one for the phase's domain or the OVERLAP stream."""
        shuf = {}
        if self.scheme == TrainMode.BOTH:
            shuf["src"] = self.source.shuffle_keys(epoch, "src", self.src.n, (self.src_cycles,))
        elif self.scheme == TrainMode.SOURCE:
            shuf["src"] = self.source.shuffle_keys(epoch, "src", self.src.n)
        elif self.scheme == TrainMode.OVERLAP:
            shuf["over"] = self.source.shuffle_keys(epoch, "over", self.n_over)
        if self.tgt is not None:
            shuf["tgt"] = self.source.shuffle_keys(epoch, "tgt", self.tgt.n)
        return {k: (keys.reshape(-1, SHUFFLE_ROUNDS).to(self.device),
                    salts.reshape(-1, SHUFFLE_ROUNDS).to(self.device))
                for k, (keys, salts) in shuf.items()}

    def run_epoch(self, epoch: int) -> torch.Tensor:
        """One epoch of optimizer steps; returns the summed loss (device
        scalar, not synchronized)."""
        shuf = self._shuffle_material(epoch)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for step_lo in range(0, self.steps_per_epoch, self.seg_steps):
            n_steps = min(self.seg_steps, self.steps_per_epoch - step_lo)
            xs = self._build_xs(shuf, epoch, step_lo, n_steps)
            for i in range(n_steps):
                rng = functools.partial(self.source.dropout_bits, epoch, step_lo + i)
                batch = {k: v[i] for k, v in xs.items()}
                if self.mesh is not None:  # this rank's data slice of the step
                    batch = {k: put_sharded(v, self.mesh) for k, v in batch.items()}
                total = total + self.step_fn(batch, rng)
        return total
