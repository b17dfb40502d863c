"""B16: DeepAPF's attention-gated score, forward, backward and grid.

Port of ``recbole_cdr_tpu/models/deepapf.py:70-101 DeepAPF._att_mlp`` and
``_forward`` and their autodiff. Each pair has an *entity* (the item in
``overlap_items`` mode, the user in ``overlap_users`` mode) with its shared
row ``e`` and its domain-only row ``o``, and the other side's row ``t``:

- ``a_s = relu((e * t) @ W + b) @ w2`` and ``a_o = relu((o * t) @ W + b) @
  w2`` (the attention MLP, ``w2`` without bias);
- ``a_s`` is -1e31 where the entity does not overlap (its id exceeds the
  overlapped count: the reference's strict ``id > overlapped_num``);
- ``(al_s, al_o) = softmax(a_s, a_o)``, ``ent = al_s e + al_o o``;
- ``logit = (ent * t) @ pl`` (``pl``: the model's ``predict_layer``).

A training call takes both domains' pairs at once, as the tables and the
ids (:class:`Tables`, :class:`Pairs`): the source pairs first, each reading
the entity side's shared table and the source domain's entity and
other-side tables by id, then the target pairs, reading the target
domain's. The kernels read every row from the tables by id; no gathered
row set exists.

Five wrappers, each counting its calls that launch:

- :func:`deepapf_forward`: logits [P] of the pairs;
- :func:`deepapf_backward`: the gradients of the five tables, every row
  written (0 where no pair names it; dense Adam reads whole tables), each
  row's terms summed in float32 in position order from the grouping of the
  step's ids (``ops/row_groups.py::group_rows``, one launch for the entity
  and the other keys, each on a ``RowPlan`` kept in :data:`_PLANS`) and
  rounded once to the tables' type (a popular row in segments of 32 terms,
  then the segments' sums in order), and of ``W``, ``b``, ``w2``, ``pl``
  (block partials added in block order): bit-equal from run to run;
- :func:`deepapf_grid`: sigmoid probabilities [B, I] of users [B] x items
  [I], the rows read from the tables by id (the predict fallback's tile; no
  [B I, D] pair tensor exists), in 2-D tiles of at most 8 users x 16 items
  whose rows the kernel stages once each, both products on the tensor
  cores.

:func:`deepapf_attention` is the differentiable form.

Under ``compute_dtype: bfloat16`` every floating operand is 16-bit (the
tables, the weights, the logits' gradient) and so is every output. The
16-bit forms (``*_bf16``, float16 through the same templates) sum in float32
and round to the operands' type where JAX's bf16 ``_forward`` has a named
intermediate: ``x_s`` and ``x_o``, ``x @ W + b``, the ``a``s, ``alpha``
after the softmax, ``entity_e``, the logit, and the grid's sigmoid. Their
backward is the float32 chain rule on those rounded values (a rounding
passes its gradient through unchanged; the softmax's slope at its unrounded
value), each gradient rounded once to the operands' type. The masked share
logit stays the float32 -1e31 inside, so under float16, where JAX's -1e31 is
-inf, ``alpha`` is 0 all the same and no NaN arises.

The kernels are ``csrc/deepapf_attention.cu``; the plain versions below run
for CPU tensors and serve as the kernels' reference (the plain gathers are
``F.embedding``, whose backward adds a row's terms in position order; the
plain backward is autograd through the plain forward).
"""

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from recbole_cdr_tpu_torch.ops import build
# B9's checks and widths (D 32, 64, 128) serve B16's kernels too
from recbole_cdr_tpu_torch.ops.natr_attention import WIDTHS, _aligned, _on_card  # noqa: F401
from recbole_cdr_tpu_torch.ops.row_groups import RowPlan, group_rows

#: the masked share logit (`deepapf.py:82,94`)
MASKED = -1e31
#: max (user, item) pairs of one chunk of the plain grid (the predict
#: fallback's budget, ``models/base.py::CrossDomainRecommender.PAIR_BUDGET``)
PAIR_BUDGET = 1 << 18


class Weights(NamedTuple):
    """The attention MLP in the JAX package's layout, ``W`` [D, D] and ``b``
    [D] (its first layer) and ``w2`` [D, 1] (its second, no bias), and the
    predict layer ``pl`` [D, 1]."""

    W: torch.Tensor
    b: torch.Tensor
    w2: torch.Tensor
    pl: torch.Tensor


class Tables(NamedTuple):
    """A call's tables: the entity side's shared table [N, D], each domain's
    entity table [N, D] and other-side table [M, D]."""

    share: torch.Tensor
    only_src: torch.Tensor
    only_tgt: torch.Tensor
    other_src: torch.Tensor
    other_tgt: torch.Tensor


class Pairs(NamedTuple):
    """A call's pairs as int32 ids, the source domain's first: each
    domain's entity ids and other-side ids (``ent_src``, ``oth_src`` [P_s];
    ``ent_tgt``, ``oth_tgt`` [P_t])."""

    ent_src: torch.Tensor
    oth_src: torch.Tensor
    ent_tgt: torch.Tensor
    oth_tgt: torch.Tensor


# ------------------------------------------------------------------ plain

def _logits(share, only, other, mask, w: Weights, r):
    """Logits [P] in the working type, rounded by ``r`` where JAX's bf16
    ``_forward`` has a named intermediate."""
    def att(x):
        return r(torch.relu(r(r(x) @ w.W + w.b)) @ w.w2)

    a_s = att(share * other)
    a_s = torch.where(mask[:, None], torch.full_like(a_s, MASKED), a_s)
    alpha = r(torch.softmax(torch.cat([a_s, att(only * other)], 1), 1))
    ent = r(alpha[:, 0:1] * share + alpha[:, 1:2] * only)
    return r((ent * other) @ w.pl).squeeze(-1)


def _gather(tabs: Tables, pairs: Pairs):
    """(shared, entity, other-side rows [P, D], entity ids [P]) of the
    pairs, by ``F.embedding``: the shared table's rows in one gather over
    both domains' ids, so its backward adds a row's terms in position
    order."""
    ent = torch.cat([pairs.ent_src, pairs.ent_tgt]).long()

    def two(src, tgt, a, b):
        return torch.cat([F.embedding(a.long(), src), F.embedding(b.long(), tgt)])

    return (F.embedding(ent, tabs.share),
            two(tabs.only_src, tabs.only_tgt, pairs.ent_src, pairs.ent_tgt),
            two(tabs.other_src, tabs.other_tgt, pairs.oth_src, pairs.oth_tgt), ent)


def deepapf_forward_plain(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights):
    """Logits [P] of the pairs in the tables' type (JAX's formula in torch,
    in float32 for 16-bit operands, rounded as they compute)."""
    dtype = tabs.share.dtype
    wide = build.wide(dtype)
    share, only, other, ent = _gather(tabs, pairs)
    return _logits(share.to(wide), only.to(wide), other.to(wide), ent > overlapped,
                   Weights(*(t.to(wide) for t in w)), build.rounding(dtype)).to(dtype)


def deepapf_backward_plain(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights, g):
    """(d_share, d_only_src, d_only_tgt, d_other_src, d_other_tgt, dW, db,
    dw2, dpl) in the tables' type: autograd through the plain forward on
    the tables widened whole, each gradient rounded once."""
    dtype = tabs.share.dtype
    with torch.enable_grad():
        leaves = [t.detach().to(build.wide(dtype)).requires_grad_() for t in (*tabs, *w)]
        share, only, other, ent = _gather(Tables(*leaves[:5]), pairs)
        logit = _logits(share, only, other, ent > overlapped, Weights(*leaves[5:]),
                        build.rounding(dtype))
        grads = torch.autograd.grad(logit, leaves, g.to(logit.dtype))
    return tuple(x.to(dtype) for x in grads)


def grid_pairs(users, items, entity_is_item: bool):
    """(entity ids, other ids) of every pair of ``users`` x ``items``, user
    by user."""
    u = users.repeat_interleave(items.shape[0])
    i = items.repeat(users.shape[0])
    return (i, u) if entity_is_item else (u, i)


def deepapf_grid_plain(share_tab, only_tab, other_tab, users, items, overlapped: int,
                       entity_is_item: bool, w: Weights):
    """Sigmoid probabilities [B, I] in the tables' type, the item axis cut
    into chunks of at most ``PAIR_BUDGET`` pairs."""
    B, I = users.shape[0], items.shape[0]
    dtype, r = share_tab.dtype, build.rounding(share_tab.dtype)
    ws = Weights(*(t.to(build.wide(dtype)) for t in w))
    chunk = max(1, PAIR_BUDGET // max(B, 1))
    tiles = [torch.zeros(B, 0, dtype=dtype, device=users.device)]
    for lo in range(0, I, chunk):
        cols = items[lo:lo + chunk]
        ent, oth = grid_pairs(users, cols, entity_is_item)
        ent, oth = ent.long(), oth.long()
        logit = _logits(*(t.to(build.wide(dtype)) for t in (share_tab[ent], only_tab[ent],
                                                        other_tab[oth])),
                        ent > overlapped, ws, r)
        tiles.append(r(torch.sigmoid(logit)).to(dtype).reshape(B, cols.shape[0]))
    return torch.cat(tiles, 1)


# ---------------------------------------------------------------- checks

def _check_weights(what: str, D: int, w: Weights):
    want = {"W": (D, D), "b": (D,), "w2": (D, 1), "pl": (D, 1)}
    for name, t in w._asdict().items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, want {want[name]}")


def _check_pairs(tabs: Tables, pairs: Pairs, w: Weights, *extra, types=tuple(build.DTYPES)):
    share, other = tabs.share, tabs.other_src
    D = share.shape[1] if share.dim() == 2 else -1
    if (share.dim() != 2 or tabs.only_src.shape != share.shape or tabs.only_tgt.shape != share.shape
            or other.dim() != 2 or other.shape[1] != D or tabs.other_tgt.shape != other.shape):
        raise ValueError("deepapf_attention: tables "
                         + ", ".join(str(tuple(t.shape)) for t in tabs))
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in pairs):
        raise TypeError("deepapf_attention takes 1-D int32 ids")
    if pairs.oth_src.shape != pairs.ent_src.shape or pairs.oth_tgt.shape != pairs.ent_tgt.shape:
        raise ValueError("deepapf_attention: one entity and one other id a pair")
    _check_weights("deepapf_attention", D, w)
    return _on_card("deepapf_attention", D, (*tabs, *w, *extra), pairs, types)


def _check_grid(share_tab, only_tab, other_tab, users, items, w: Weights, types):
    D = share_tab.shape[1] if share_tab.dim() == 2 else -1
    if (share_tab.dim() != 2 or only_tab.shape != share_tab.shape or other_tab.dim() != 2
            or other_tab.shape[1] != D or users.dim() != 1 or items.dim() != 1):
        raise ValueError(f"deepapf_grid: tables {tuple(share_tab.shape)}, "
                         f"{tuple(only_tab.shape)}, {tuple(other_tab.shape)}, users "
                         f"{tuple(users.shape)}, items {tuple(items.shape)}")
    _check_weights("deepapf_grid", D, w)
    return _on_card("deepapf_grid", D, (share_tab, only_tab, other_tab, *w), (users, items),
                    types)


# --------------------------------------------------------------- wrappers

def _addresses(tensors):
    """A C array of the tensors' addresses."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _operands(tabs: Tables, pairs: Pairs, w: Weights):
    """(the tables, the ids and the weights, contiguous and 16-byte aligned
    where the kernels load 16 bytes; the source pairs; all pairs)."""
    keep = _aligned(*tabs, *w)
    ids = [t.contiguous() for t in pairs]
    n_src = ids[0].shape[0]
    return keep[:5], ids, keep[5:], n_src, n_src + ids[2].shape[0]


def _forward(tabs: Tables, pairs: Pairs, overlapped, w: Weights, name):
    tables, ids, ws, n_src, n = _operands(tabs, pairs, w)
    D = tabs.share.shape[1]
    out = torch.empty(n, dtype=tabs.share.dtype, device=tabs.share.device)
    err = build.library("deepapf_attention").deepapf_forward(
        _addresses(tables), _addresses(ids), n_src, n, int(overlapped),
        *(x.data_ptr() for x in ws), D, out.data_ptr(), build.DTYPES[tabs.share.dtype],
        build.stream_handle(out))
    build.check(err, name)
    return out


def deepapf_forward(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights):
    """Logits [P_s + P_t] of the pairs, the source pairs' first, in the
    tables' type; a pair's share logit is masked where its entity id exceeds
    ``overlapped``. 16-bit operands go to :func:`deepapf_forward_bf16`."""
    if not _check_pairs(tabs, pairs, w):
        return deepapf_forward_plain(tabs, pairs, overlapped, w)
    if tabs.share.dtype != torch.float32:
        return deepapf_forward_bf16(tabs, pairs, overlapped, w)
    out = _forward(tabs, pairs, overlapped, w, "deepapf_forward")
    deepapf_forward.launches += 1
    return out


deepapf_forward.launches = 0


def deepapf_forward_bf16(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights):
    """B16's 16-bit forward: bfloat16 (or float16) operands, float32 sums,
    logits rounded at JAX's bf16 intermediates."""
    if not _check_pairs(tabs, pairs, w, types=build.FLOAT16):
        return deepapf_forward_plain(tabs, pairs, overlapped, w)
    out = _forward(tabs, pairs, overlapped, w, "deepapf_forward_bf16")
    deepapf_forward_bf16.launches += 1
    return out


deepapf_forward_bf16.launches = 0


#: per (device, rows, 0 for the entity keys or 1 for the other keys), the
#: kept plan of the backward's groupings
_PLANS = {}


def _plan(device, rows: int, slot: int, capacity: int) -> RowPlan:
    key = (device, rows, slot)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = RowPlan(rows, device, capacity=capacity)
    return plan


def _backward(tabs: Tables, pairs: Pairs, overlapped, w: Weights, g, name):
    """Launch (1) writes each pair's row gradients (float32) and keys, the
    plan groups the keys (one ``group_rows`` launch), launch (2) writes the
    five tables' gradients and adds the weights'."""
    tables, ids, ws, n_src, n = _operands(tabs, pairs, w)
    if g.shape != (n,):
        raise ValueError(f"{name}: one gradient per pair")
    g = g.contiguous()
    dev, dtype, code = g.device, tabs.share.dtype, build.DTYPES[tabs.share.dtype]
    (N, D), M = tabs.share.shape, tabs.other_src.shape[0]
    n_part = D * D + 3 * D
    lib, stream = build.library("deepapf_attention"), build.stream_handle(g)
    blocks = lib.deepapf_backward_blocks(D, n, code)
    if blocks < 0:
        build.check(-blocks, name)
    rows = torch.empty(3, n, D, dtype=torch.float32, device=dev)
    keys = torch.empty(2, n, dtype=torch.int32, device=dev)
    partial = torch.empty(max(blocks, 1), n_part, dtype=torch.float32, device=dev)
    build.check(lib.deepapf_backward(
        _addresses(tables), _addresses(ids), n_src, n, N, M, int(overlapped),
        *(x.data_ptr() for x in ws), D, g.data_ptr(), rows.data_ptr(), keys.data_ptr(),
        partial.data_ptr(), blocks, code, stream), name)
    ge, go = group_rows(keys[0], _plan(dev, 2 * N, 0, n),
                        second=(keys[1], _plan(dev, 2 * M, 1, n)))
    grads = [torch.empty(t.shape, dtype=dtype, device=dev) for t in tables]
    flat = torch.empty(n_part, dtype=dtype, device=dev)
    build.check(lib.deepapf_backward_tables(
        partial.data_ptr(), blocks, flat.data_ptr(), rows.data_ptr(), n, D, ge.pointers(),
        go.pointers(), _addresses(grads), N, M, code, stream), name)
    dW, db, dw2, dpl = torch.split(flat, [D * D, D, D, D])
    return (*grads, dW.reshape(D, D), db, dw2.reshape(D, 1), dpl.reshape(D, 1))


def deepapf_backward(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights, g):
    """(d_share, d_only_src, d_only_tgt, d_other_src, d_other_tgt, dW, db,
    dw2, dpl) from the gradient ``g`` [P] of the logits, in the tables' type,
    every table row written; 16-bit operands go to
    :func:`deepapf_backward_bf16`."""
    if not _check_pairs(tabs, pairs, w, g):
        return deepapf_backward_plain(tabs, pairs, overlapped, w, g)
    if tabs.share.dtype != torch.float32:
        return deepapf_backward_bf16(tabs, pairs, overlapped, w, g)
    out = _backward(tabs, pairs, overlapped, w, g, "deepapf_backward")
    deepapf_backward.launches += 1
    return out


deepapf_backward.launches = 0


def deepapf_backward_bf16(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights, g):
    """B16's 16-bit backward: the float32 chain rule on the forward's rounded
    values, each table row and each weight gradient summed in float32 and
    rounded once."""
    if not _check_pairs(tabs, pairs, w, g, types=build.FLOAT16):
        return deepapf_backward_plain(tabs, pairs, overlapped, w, g)
    out = _backward(tabs, pairs, overlapped, w, g, "deepapf_backward_bf16")
    deepapf_backward_bf16.launches += 1
    return out


deepapf_backward_bf16.launches = 0


def _grid(share_tab, only_tab, other_tab, users, items, overlapped, entity_is_item, w, name):
    keep = _aligned(share_tab, only_tab, other_tab, users.to(torch.int32),
                    items.to(torch.int32), w.W, w.b, w.w2, w.pl)
    B, I, D = users.shape[0], items.shape[0], share_tab.shape[1]
    out = torch.empty(B, I, dtype=share_tab.dtype, device=users.device)
    err = build.library("deepapf_attention").deepapf_grid(
        *(x.data_ptr() for x in keep[:5]), B, I, int(overlapped), int(entity_is_item),
        *(x.data_ptr() for x in keep[5:]), D, out.data_ptr(), build.DTYPES[share_tab.dtype],
        build.stream_handle(users))
    build.check(err, name)
    return out


def deepapf_grid(share_tab, only_tab, other_tab, users, items, overlapped: int,
                 entity_is_item: bool, w: Weights):
    """Sigmoid probabilities [B, I] of every pair of ``users`` [B] x ``items``
    [I], in the tables' type: the entity is ``items[i]`` when
    ``entity_is_item``, else ``users[b]``; its rows come from ``share_tab``
    and ``only_tab``, the other side's from ``other_tab``; the share logit
    is masked where the entity id exceeds ``overlapped``. 16-bit operands go
    to :func:`deepapf_grid_bf16`."""
    args = (share_tab, only_tab, other_tab, users, items, overlapped, entity_is_item, w)
    if not _check_grid(share_tab, only_tab, other_tab, users, items, w, tuple(build.DTYPES)):
        return deepapf_grid_plain(*args)
    if share_tab.dtype != torch.float32:
        return deepapf_grid_bf16(*args)
    out = _grid(*args, "deepapf_grid")
    deepapf_grid.launches += 1
    return out


deepapf_grid.launches = 0


def deepapf_grid_bf16(share_tab, only_tab, other_tab, users, items, overlapped: int,
                      entity_is_item: bool, w: Weights):
    """B16's 16-bit grid: the 16-bit forward's roundings, then the sigmoid
    rounded to the tables' type."""
    args = (share_tab, only_tab, other_tab, users, items, overlapped, entity_is_item, w)
    if not _check_grid(share_tab, only_tab, other_tab, users, items, w, build.FLOAT16):
        return deepapf_grid_plain(*args)
    out = _grid(*args, "deepapf_grid_bf16")
    deepapf_grid_bf16.launches += 1
    return out


deepapf_grid_bf16.launches = 0


class _DeepAPFAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pairs, overlapped, *floats):
        ctx.save_for_backward(*floats)
        ctx.pairs, ctx.overlapped = pairs, overlapped
        return deepapf_forward(Tables(*floats[:5]), pairs, overlapped, Weights(*floats[5:]))

    @staticmethod
    def backward(ctx, g):
        floats = ctx.saved_tensors
        grads = deepapf_backward(Tables(*floats[:5]), ctx.pairs, ctx.overlapped,
                                 Weights(*floats[5:]), g)
        return (None, None, *grads)


def deepapf_attention(tabs: Tables, pairs: Pairs, overlapped: int, w: Weights):
    """Differentiable logits [P_s + P_t] of the pairs: gradients reach the
    five tables (whole, as dense Adam reads them) and the four weights."""
    return _DeepAPFAttention.apply(pairs, overlapped, *tabs, *w)
