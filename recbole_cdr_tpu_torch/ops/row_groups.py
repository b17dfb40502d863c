"""A step's ids grouped by row, and the row sum that reads the grouping.

The grouping ("plan", :func:`group_rows`) of ids [R] over the rows
``[offset, offset + L)`` of a table or of a shard of one lists each distinct
row the ids name ("head") with the positions of its occurrences, in
ascending order; ids outside the rows are left out. The fixed-order sums
read it: K1's backward (``ops/gather_dot.py``), B6 (``ops/sparse_adam.py``)
and the row-sharded lookup's backward (:func:`row_sum`), so that each runs
in an order the ids alone fix and two runs on the card are bit-equal. It
replaces the grouping XLA does inside its scatter-add and scatter-min
(``recbole_cdr_tpu/models/cmf.py:45-48``'s autodiff,
``recbole_cdr_tpu/trainer/trainer.py:274-311``).

The kernels are ``csrc/row_groups.cu``: the plan is integer work only and
O(R) a step, by inboxes in shared memory up to 16,384 ids and by four
rounds of atomics above. Each table (or shard) keeps a :class:`RowPlan`,
built once where its caller keeps its state: two int32 arrays of L (so a
1.1M-row table costs nothing per step), the :class:`Groups` buffer and the
kernels' scratch at the largest R seen, and the C array of their addresses. A step's
call checks the ids and makes one C call with ints; it allocates nothing
unless R grows past every earlier step's. The card's heads come in no set
order; each head's positions are in position order. The plain versions
below (a stable sort, heads in row order) run for CPU tensors and serve as
the kernels' reference.
"""

import ctypes
import torch

from recbole_cdr_tpu_torch.ops import build

#: a head of more positions is summed by a whole block in the kernels that
#: read a grouping (``kBigTerms`` of ``csrc/row_groups.cuh``)
BIG_TERMS = 64
#: the most ids a grouping takes through the inboxes (``kInboxMax`` of
#: ``csrc/row_groups.cu``); a launch whose larger grouping has more runs the
#: four rounds
INBOX_IDS = 16_384


class Groups:
    """A grouping of ``R`` ids over rows ``[offset, offset + L)``, int32
    tensors: ``meta[0]`` the ids inside the rows, ``meta[1]`` the heads H,
    ``meta[2]`` the heads of more than :data:`BIG_TERMS` positions; for h <
    H, ``head_row[h]`` its row (local: id - offset) and
    ``pos[head_start[h]:head_start[h] + head_len[h]]`` its positions,
    ascending; ``row_head[r]`` the head of local row r where
    ``head_row[row_head[r]] == r`` (on the card the array is kept between
    steps and never cleared, so other entries are stale; -1 in the plain
    version); ``big[:meta[2]]`` the heads of more than :data:`BIG_TERMS`
    positions, which the kernels sum a block each (in no set order on the
    card). All but ``row_head`` lie in one int32 buffer: ``meta`` (4), then
    ``head_row``, ``head_start``, ``head_len``, ``pos`` and ``big`` of
    ``stride`` >= max(R, 1) each (and the card's scratch after them); the
    fields are views of it. On the card the object belongs to its
    :class:`RowPlan` and holds the plan's last grouping."""

    __slots__ = ("R", "L", "offset", "buf", "row_head", "stride", "_ptrs")

    def __init__(self, R, L, offset, buf, row_head, stride=None):
        self.R, self.L, self.offset, self.buf, self.row_head = R, L, offset, buf, row_head
        self.stride = max(R, 1) if stride is None else stride
        self._ptrs = None

    @property
    def meta(self):
        return self.buf[:4]

    def _field(self, k):
        n = self.stride
        return self.buf[4 + k * n:4 + (k + 1) * n]

    head_row = property(lambda self: self._field(0))
    head_start = property(lambda self: self._field(1))
    head_len = property(lambda self: self._field(2))
    pos = property(lambda self: self._field(3))
    big = property(lambda self: self._field(4))

    def pointers(self):
        """A C array of the seven arrays' addresses (meta, head_row,
        head_start, head_len, pos, row_head, big), in the order the kernels
        take them; built once, kept with the object."""
        if self._ptrs is None:
            base, n = self.buf.data_ptr(), 4 * self.stride
            self._ptrs = (ctypes.c_void_p * 7)(base, base + 16, base + 16 + n,
                                               base + 16 + 2 * n, base + 16 + 3 * n,
                                               self.row_head.data_ptr(), base + 16 + 4 * n)
        return self._ptrs


class RowPlan:
    """What the plans of one table (or one shard: rows ``[offset, offset +
    n_rows)``) keep from step to step, made once by the caller that keeps
    the table's state: on the card the int32 [2, n_rows] counters (zeros,
    which every plan leaves so) and row -> head map (never cleared), the
    :class:`Groups` buffer and the four rounds' ``tick`` / ``tmp`` at the
    largest R planned so far (``capacity``), and the C array of the ten
    addresses the kernels take (the counters, tick and tmp serve the four
    rounds alone, above 16,384 ids). On the CPU it holds the rows alone.
    ``generation`` counts the plans made; a grouping read after a later plan
    on the same object is stale."""

    def __init__(self, n_rows: int, device, offset: int = 0, capacity: int = 0):
        if n_rows < 0 or not 0 <= offset <= 2 ** 31 - 1 - n_rows:
            raise ValueError(f"RowPlan: rows [{offset}, {offset} + {n_rows})")
        self.L, self.offset, self.device = n_rows, offset, torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"group_rows has no version for device {self.device}")
        self.generation = 0
        self.capacity, self.groups, self._addr = 0, None, None
        if self.device.type == "cuda":
            self.scratch = torch.zeros((2, n_rows), dtype=torch.int32, device=self.device)
            self._grow(max(capacity, 1))

    def __deepcopy__(self, memo):
        """A copy (of a model that keeps the plan) shares none of the
        scratch: a fresh plan of the same rows."""
        return RowPlan(self.L, self.device, self.offset, self.capacity)

    def _grow(self, R: int):
        """The Groups buffer, then the kernel's tick and tmp, at stride R;
        meta first, 8-byte aligned: the kernel adds to its first two at
        once."""
        self.capacity = R
        buf = torch.empty(4 + 7 * R, dtype=torch.int32, device=self.device)
        self.groups = Groups(0, self.L, self.offset, buf, self.scratch[1], stride=R)
        base, cnt = buf.data_ptr(), self.scratch.data_ptr()
        self._ptrs = (ctypes.c_void_p * 10)(cnt, cnt + 4 * self.L, base,
                                            *(base + 16 + 4 * R * k for k in range(7)))
        self._addr = ctypes.addressof(self._ptrs)


def _local(ids, n_rows, offset):
    local = ids.long() - offset
    return local, (local >= 0) & (local < n_rows)


def group_rows_plain(ids, n_rows: int, offset: int = 0) -> Groups:
    """The grouping in torch: heads in row order, each head's positions
    ascending (a stable sort by row)."""
    R, dev = ids.shape[0], ids.device
    local, own = _local(ids, n_rows, offset)
    where = torch.nonzero(own).flatten()
    order = torch.sort(local[where], stable=True).indices
    pos = where[order]
    heads, counts = torch.unique_consecutive(local[pos], return_counts=True)
    H = heads.shape[0]

    def padded(t):
        out = torch.zeros(max(R, 1), dtype=torch.int32, device=dev)
        out[:t.shape[0]] = t.to(torch.int32)
        return out

    row_head = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    row_head[heads] = torch.arange(H, dtype=torch.int32, device=dev)
    big = torch.nonzero(counts > BIG_TERMS).flatten()
    meta = torch.tensor([pos.shape[0], H, big.shape[0], 0], dtype=torch.int32, device=dev)
    buf = torch.cat([meta, padded(heads), padded(torch.cumsum(counts, 0) - counts),
                     padded(counts), padded(pos), padded(big)])
    return Groups(R, n_rows, offset, buf, row_head)


def canonical(groups: Groups):
    """``(rows, lengths, positions)`` of a grouping with its heads in row
    order, as int64 tensors on the CPU: equal for the card's plan and the
    plain version's."""
    meta = groups.meta.cpu()
    H = int(meta[1])
    rows = groups.head_row[:H].long().cpu()
    order = torch.argsort(rows)
    start = groups.head_start[:H].long().cpu()[order]
    lens = groups.head_len[:H].long().cpu()[order]
    pos = groups.pos.long().cpu()
    parts = [pos[s:s + n] for s, n in zip(start.tolist(), lens.tolist())]
    return rows[order], lens, torch.cat(parts) if parts else pos[:0]


def _ready(ids, plan: RowPlan):
    """The ids' length, after the per-step checks (the plan's own were made
    once), growing the plan's buffer where the ids outgrow it."""
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError("group_rows takes 1-D int32 ids")
    if ids.device != plan.device:
        raise ValueError(f"group_rows: ids on {ids.device}, a plan of rows on {plan.device}")
    R = ids.shape[0]
    if R > plan.capacity and plan.device.type == "cuda":
        plan._grow(R)
    return R


def group_rows(ids, plan: RowPlan, second=None):
    """The :class:`Groups` of int32 ``ids`` [R] over the rows of ``plan``
    (its table's :class:`RowPlan`, kept by the caller from step to step; on
    the card the grouping is the plan's own object and holds until the next
    plan on it). ``second``: another ``(ids, plan)`` grouped in the same
    launch; then both groupings are returned, in that order."""
    if ids.device.type == "cpu":
        sets = [(ids, plan)] + ([tuple(second)] if second else [])
        for i, p in sets:
            _ready(i, p)
        out = []
        for i, p in sets:
            out.append(group_rows_plain(i, p.L, p.offset))
            p.generation += 1
        return tuple(out) if second else out[0]
    R0 = _ready(ids, plan)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if second:
        ids1, plan1 = second
        if plan1 is plan:
            raise ValueError("group_rows: two groupings need two plans")
        R1 = _ready(ids1, plan1)
        if not ids1.is_contiguous():
            ids1 = ids1.contiguous()
        rest = (ids1.data_ptr(), R1, plan1.L, plan1.offset, plan1._addr)
    else:
        rest = (None, 0, 0, 0, None)
    err = build.library("row_groups").row_groups_plan(
        2 if second else 1, ids.data_ptr(), R0, plan.L, plan.offset, plan._addr, *rest,
        build.stream_handle(ids))
    build.check(err, "group_rows")
    group_rows.launches += 1
    plan.generation += 1
    plan.groups.R = R0
    if not second:
        return plan.groups
    plan1.generation += 1
    plan1.groups.R = R1
    return plan.groups, plan1.groups


group_rows.launches = 0


def row_sum_plain(src, groups: Groups, ids):
    """The rows of ``src`` whose ``ids`` fall in the grouping's rows added
    into float32 zeros [L, D] in position order (``index_add_``), rounded
    once to ``src``'s type: what ``index_add_`` in that type computes on
    the CPU."""
    local, own = _local(ids, groups.L, groups.offset)
    out = torch.zeros((groups.L,) + tuple(src.shape[1:]), device=src.device)
    return out.index_add_(0, local[own], src[own].float()).to(src.dtype)


def row_sum(src, ids, groups: Groups):
    """[L, D] of ``src``'s type: for each row of the grouping, the rows of
    ``src`` [R, D] at its positions added in float32 in position order and
    rounded once (0 for a row no id names), the function of
    :func:`row_sum_plain`. ``groups``: the
    :class:`Groups` of ``ids`` (the plain version on the CPU reads the ids
    instead)."""
    if src.dtype not in build.DTYPES or src.dim() != 2:
        raise TypeError(f"row_sum takes [R, D] rows of a type of {tuple(build.DTYPES)}")
    if ids.shape != (src.shape[0],) or groups.R != src.shape[0]:
        raise ValueError(f"row_sum: {src.shape[0]} rows, {ids.shape[0]} ids, a grouping of "
                         f"{groups.R}")
    if src.device.type == "cpu":
        return row_sum_plain(src, groups, ids)
    if src.device.type != "cuda" or groups.meta.device != src.device:
        raise ValueError(f"row_sum has no version for device {src.device}")
    src = src.contiguous()
    D = src.shape[1]
    out = torch.empty((groups.L, D), dtype=src.dtype, device=src.device)
    vec = int(D * src.element_size() % 16 == 0 and src.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    err = build.library("row_groups").row_sum(
        src.data_ptr(), groups.L, D, build.DTYPES[src.dtype], vec, groups.pointers(),
        out.data_ptr(), build.stream_handle(src))
    build.check(err, "row_sum")
    row_sum.launches += 1
    return out


row_sum.launches = 0
