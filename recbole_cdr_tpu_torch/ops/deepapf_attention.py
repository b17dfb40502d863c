"""B16: DeepAPF's attention-gated score, forward, backward and grid.

Port of ``recbole_cdr_tpu/models/deepapf.py:70-101 DeepAPF._att_mlp`` and
``_forward`` and their autodiff. Each pair has an *entity* (the item in
``overlap_items`` mode, the user in ``overlap_users`` mode) with its shared
row ``e`` and its domain-only row ``o``, and the other side's row ``t``:

- ``a_s = relu((e * t) @ W + b) @ w2`` and ``a_o = relu((o * t) @ W + b) @
  w2`` (the attention MLP, ``w2`` without bias);
- ``a_s`` is -1e31 where the entity does not overlap (``mask``: the
  caller's ``id > overlapped_num``, strict as the reference's);
- ``(al_s, al_o) = softmax(a_s, a_o)``, ``ent = al_s e + al_o o``;
- ``logit = (ent * t) @ pl`` (``pl``: the model's ``predict_layer``).

Three wrappers, each counting its calls that launch:

- :func:`deepapf_forward`: logits [P] of P gathered pairs;
- :func:`deepapf_backward`: the gradients of the three row sets [P, D] and
  of ``W``, ``b``, ``w2``, ``pl`` (summed over the pairs, block partials
  added in block order: bit-equal from run to run); the scatter of the row
  gradients into the tables stays the gathers' own autograd;
- :func:`deepapf_grid`: sigmoid probabilities [B, I] of users [B] x items
  [I], the rows read from the tables by id (the predict fallback's tile; no
  [B I, D] pair tensor exists).

:func:`deepapf_attention` is the differentiable form.

Under ``compute_dtype: bfloat16`` every floating operand is 16-bit (the
rows, the tables, the weights, the logits' gradient) and so is every
output. The 16-bit forms (``*_bf16``, float16 through the same templates)
sum in float32 and round to the operands' type where JAX's bf16 ``_forward``
has a named intermediate: ``x_s`` and ``x_o``, ``x @ W + b``, the ``a``s,
``alpha`` after the softmax, ``entity_e``, the logit, and the grid's
sigmoid. Their backward is the float32 chain rule on those rounded values
(a rounding passes its gradient through unchanged; the softmax's slope at
its unrounded value), each gradient rounded once to the operands' type. The
masked share logit stays the float32 -1e31 inside, so under float16, where
JAX's -1e31 is -inf, ``alpha`` is 0 all the same and no NaN arises.

The kernels are ``csrc/deepapf_attention.cu``; the plain versions below run
for CPU tensors and serve as the kernels' reference (the plain backward is
autograd through the plain forward).
"""

from typing import NamedTuple

import torch

from recbole_cdr_tpu_torch.ops import build
# B9's checks and widths (D 32, 64, 128) serve B16's kernels too
from recbole_cdr_tpu_torch.ops.natr_attention import WIDTHS, _aligned, _on_card  # noqa: F401

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


def deepapf_forward_plain(share, only, other, mask, w: Weights):
    """Logits [P] of the pairs in the operands' type (JAX's formula in torch,
    in float32 for 16-bit operands, rounded as they compute)."""
    dtype = share.dtype
    share, only, other, *ws = (t.to(build.wide(dtype)) for t in (share, only, other, *w))
    return _logits(share, only, other, mask, Weights(*ws), build.rounding(dtype)).to(dtype)


def deepapf_backward_plain(share, only, other, mask, w: Weights, g):
    dtype = share.dtype
    with torch.enable_grad():
        leaves = [t.detach().to(build.wide(dtype)).requires_grad_()
                  for t in (share, only, other, *w)]
        logit = _logits(leaves[0], leaves[1], leaves[2], mask, Weights(*leaves[3:]),
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


def _check_pairs(share, only, other, mask, w: Weights, *extra, types=tuple(build.DTYPES)):
    D = share.shape[1] if share.dim() == 2 else -1
    if share.dim() != 2 or only.shape != share.shape or other.shape != share.shape:
        raise ValueError(f"deepapf_attention: share {tuple(share.shape)}, only "
                         f"{tuple(only.shape)}, other {tuple(other.shape)}")
    if mask.dtype != torch.bool or mask.shape != (share.shape[0],):
        raise ValueError("deepapf_attention takes a bool mask [P]")
    _check_weights("deepapf_attention", D, w)
    return _on_card("deepapf_attention", D, (share, only, other, *w, *extra), (mask,), types)


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

def _forward(share, only, other, mask, w: Weights, name):
    keep = _aligned(share, only, other, mask, w.W, w.b, w.w2, w.pl)
    P, D = share.shape
    out = torch.empty(P, dtype=share.dtype, device=share.device)
    err = build.library("deepapf_attention").deepapf_forward(
        *(x.data_ptr() for x in keep), P, D, out.data_ptr(), build.DTYPES[share.dtype],
        build.stream_handle(share))
    build.check(err, name)
    return out


def deepapf_forward(share, only, other, mask, w: Weights):
    """Logits [P] of the pairs (row p of ``share``, ``only``, ``other``;
    ``mask[p]`` masks the pair's share logit), in the operands' type; 16-bit
    operands go to :func:`deepapf_forward_bf16`."""
    if not _check_pairs(share, only, other, mask, w):
        return deepapf_forward_plain(share, only, other, mask, w)
    if share.dtype != torch.float32:
        return deepapf_forward_bf16(share, only, other, mask, w)
    out = _forward(share, only, other, mask, w, "deepapf_forward")
    deepapf_forward.launches += 1
    return out


deepapf_forward.launches = 0


def deepapf_forward_bf16(share, only, other, mask, w: Weights):
    """B16's 16-bit forward: bfloat16 (or float16) operands, float32 sums,
    logits rounded at JAX's bf16 intermediates."""
    if not _check_pairs(share, only, other, mask, w, types=build.FLOAT16):
        return deepapf_forward_plain(share, only, other, mask, w)
    out = _forward(share, only, other, mask, w, "deepapf_forward_bf16")
    deepapf_forward_bf16.launches += 1
    return out


deepapf_forward_bf16.launches = 0


def _backward(share, only, other, mask, w: Weights, g, name):
    if g.shape != (share.shape[0],):
        raise ValueError(f"{name}: one gradient per pair")
    keep = _aligned(share, only, other, mask, w.W, w.b, w.w2, w.pl, g)
    P, D = share.shape
    d_rows = [torch.empty(P, D, dtype=share.dtype, device=share.device) for _ in range(3)]
    n_part = D * D + 3 * D
    lib = build.library("deepapf_attention")
    blocks = lib.deepapf_backward_blocks(D, P, build.DTYPES[share.dtype])
    if blocks < 0:
        build.check(-blocks, name)
    partial = torch.empty(max(blocks, 1), n_part, dtype=torch.float32, device=share.device)
    flat = torch.empty(n_part, dtype=share.dtype, device=share.device)
    err = lib.deepapf_backward(*(x.data_ptr() for x in keep[:8]), P, D, keep[8].data_ptr(),
                               *(x.data_ptr() for x in d_rows), partial.data_ptr(), blocks,
                               flat.data_ptr(), build.DTYPES[share.dtype],
                               build.stream_handle(share))
    build.check(err, name)
    dW, db, dw2, dpl = torch.split(flat, [D * D, D, D, D])
    return (*d_rows, dW.reshape(D, D), db, dw2.reshape(D, 1), dpl.reshape(D, 1))


def deepapf_backward(share, only, other, mask, w: Weights, g):
    """(d_share, d_only, d_other, dW, db, dw2, dpl) from the gradient ``g``
    [P] of the logits, in the operands' type; 16-bit operands go to
    :func:`deepapf_backward_bf16`."""
    if not _check_pairs(share, only, other, mask, w, g):
        return deepapf_backward_plain(share, only, other, mask, w, g)
    if share.dtype != torch.float32:
        return deepapf_backward_bf16(share, only, other, mask, w, g)
    out = _backward(share, only, other, mask, w, g, "deepapf_backward")
    deepapf_backward.launches += 1
    return out


deepapf_backward.launches = 0


def deepapf_backward_bf16(share, only, other, mask, w: Weights, g):
    """B16's 16-bit backward: the float32 chain rule on the forward's rounded
    values, float32 partial sums, each gradient rounded once."""
    if not _check_pairs(share, only, other, mask, w, g, types=build.FLOAT16):
        return deepapf_backward_plain(share, only, other, mask, w, g)
    out = _backward(share, only, other, mask, w, g, "deepapf_backward_bf16")
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
    def forward(ctx, share, only, other, W, b, w2, pl, mask):
        ctx.save_for_backward(share, only, other, W, b, w2, pl)
        ctx.mask = mask
        return deepapf_forward(share, only, other, mask, Weights(W, b, w2, pl))

    @staticmethod
    def backward(ctx, g):
        share, only, other, *w = ctx.saved_tensors
        grads = deepapf_backward(share, only, other, ctx.mask, Weights(*w), g.contiguous())
        return (*grads, None)


def deepapf_attention(share, only, other, mask, w: Weights):
    """Differentiable logits [P]: gradients reach the three row sets and the
    four weights."""
    return _DeepAPFAttention.apply(share, only, other, *w, mask)
