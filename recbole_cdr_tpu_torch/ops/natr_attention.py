"""B9: NATR's history attention, forward, backward and full-sort.

Port of ``recbole_cdr_tpu/models/natr.py:101-128 NATR._phase2_logit`` and
its autodiff. Each score has an *anchor* (the user in ``overlap_items``
mode, the item in ``overlap_users`` mode) with its target embedding ``pu``
and a source-domain history, and a *query* vector ``q`` (the other side's
target embedding). With ``h_j = src[hist[a, j]] @ W + b`` for every slot
``j < H`` (padded slots gather row 0 and stay in the softmax, masked by
-10000):

- anchor stage: ``s_j = relu(pu * h_j) . w_ua + b_ua + (mask_j ? 0 :
  -10000)``, ``att = softmax(s)``, ``su = sum_j att_j h_j``;
- pair stage: ``b_s = relu(su * q) . w_da + b_da``, ``b_p = relu(pu * q) .
  w_da + b_da``, ``beta = exp(b_s) / (exp(b_s) + exp(b_p))`` (JAX's literal
  form), ``logit = (beta su + (1 - beta) pu) . q``.

``su`` and ``pu`` depend on the anchor alone, so the kernels compute the
anchor stage once per anchor and the O(D) pair stage per pair. Four
wrappers, each counting its calls that launch:

- :func:`natr_attention_forward`: training, one anchor per pair, logits [P]
  (two kernels);
- :func:`natr_attention_backward`: the gradients of ``pu``, ``q``, ``W``,
  ``b``, ``w_ua``, ``b_ua``, ``w_da``, ``b_da`` (none for the source table,
  which NATR freezes in the phase that runs this; two kernels);
- :func:`natr_anchor_table`: ``su`` of a set of anchors, the anchor stage
  alone (full-sort scoring builds it once per parameter version);
- :func:`natr_pair_grid`: a [rows, cols] grid of sigmoid probabilities from
  the anchors' ``su`` and ``pu``, the anchors on the rows
  (``overlap_items``) or on the columns.

:func:`natr_full_sort` composes the last two.

The kernels are ``csrc/natr_attention.cu``; the plain versions below run for
CPU tensors and serve as the kernels' reference (the plain backward is
autograd through the plain forward).
"""

from typing import NamedTuple

import torch

from recbole_cdr_tpu_torch.ops import build

#: the kernels' widths (D = source width = target width), threads per block
#: and shared-memory budget
WIDTHS = (32, 64, 128)
THREADS = 256
SMEM_LIMIT = 227 * 1024


class Weights(NamedTuple):
    """The attention's weights in the JAX package's layout: ``transfer``
    ``W`` [D, D] and ``b`` [D]; ``unit_attention`` ``w_ua`` [D, 1] and
    ``b_ua`` [1]; ``domain_attention`` ``w_da`` [D, 1] and ``b_da`` [1]."""

    W: torch.Tensor
    b: torch.Tensor
    w_ua: torch.Tensor
    b_ua: torch.Tensor
    w_da: torch.Tensor
    b_da: torch.Tensor


class History(NamedTuple):
    """The source table the history indexes (float32 [N, D]), the history
    matrix (int32 [N_anchor, H]) and its mask (bool [N_anchor, H])."""

    src: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor


# ------------------------------------------------------------------ plain

def anchor_plain(hist: History, anchors, pu, w: Weights):
    """su [A, D] of the anchors ``anchors`` (int32 [A]) with ``pu`` [A, D]."""
    a = anchors.long()
    he = hist.src[hist.ids[a].long()] @ w.W + w.b                       # [A, H, D]
    att = (torch.relu(pu[:, None, :] * he) @ w.w_ua + w.b_ua).squeeze(-1)
    att = att + torch.where(hist.mask[a], 0.0, -10000.0)
    att = torch.softmax(att, dim=1)
    return torch.einsum("bh,bhd->bd", att, he)


def blend_plain(su, pu, q, w: Weights):
    """Logits of the pair stage; ``su``, ``pu`` and ``q`` broadcast
    against each other over their leading dimensions."""
    b_s = torch.relu(su * q) @ w.w_da + w.b_da
    b_p = torch.relu(pu * q) @ w.w_da + w.b_da
    beta = torch.exp(b_s) / (torch.exp(b_s) + torch.exp(b_p))
    zu = beta * su + (1 - beta) * pu
    return (zu * q).sum(-1)


def natr_attention_forward_plain(hist: History, anchors, pu, q, w: Weights):
    return blend_plain(anchor_plain(hist, anchors, pu, w), pu, q, w)


def natr_attention_backward_plain(hist: History, anchors, pu, q, w: Weights, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (pu, q, *w)]
        logit = natr_attention_forward_plain(hist, anchors, leaves[0], leaves[1],
                                             Weights(*leaves[2:]))
        return torch.autograd.grad(logit, leaves, g)


def pair_grid_plain(su, pu, q, w: Weights, anchor_is_row: bool):
    """Sigmoid probabilities of every (anchor, query) pair: [A, Nq] when
    ``anchor_is_row``, else [Nq, A]."""
    if anchor_is_row:
        logit = blend_plain(su[:, None, :], pu[:, None, :], q[None, :, :], w)
    else:
        logit = blend_plain(su[None, :, :], pu[None, :, :], q[:, None, :], w)
    return torch.sigmoid(logit)


def natr_full_sort_plain(hist: History, anchors, pu, q, w: Weights, anchor_is_row: bool):
    return pair_grid_plain(anchor_plain(hist, anchors, pu, w), pu, q, w, anchor_is_row)


# ---------------------------------------------------------------- checks

def smem_bytes(D: int, H: int) -> int:
    """The kernels' dynamic shared memory for width D and H history slots
    (``csrc/natr_attention.cu``: the transfer weight, the gathered history
    rows with a padded stride, the transferred rows, per-slot and per-width
    vectors and a reduction scratch)."""
    rows = 4 * THREADS // (D // 4)
    hp = -(-max(H, 1) // rows) * rows
    floats = D * D + hp * (D + 1) + hp * D + 3 * hp + 4 * D + THREADS
    return 4 * floats + 4 * hp + hp


def _on_card(what: str, D: int, floats, others=()) -> bool:
    """The checks every wrapper shares: float32 ``floats``, every operand on
    one device, a device with a version, and on the card a width the kernels
    take. Returns whether the operands lie on the card."""
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what} takes float32 tables, embeddings and weights")
    if len({t.device for t in (*floats, *others)}) != 1:
        raise ValueError(f"{what} operands must share one device")
    dev = floats[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no version for device {floats[0].device}")
    if dev == "cuda" and D not in WIDTHS:
        raise ValueError(f"{what}: the kernel takes widths {WIDTHS}, got {D}")
    return dev == "cuda"


def _aligned(*tensors):
    """Contiguous copies, 16-byte aligned for the kernels' float4 loads."""
    t = [x.contiguous() for x in tensors]
    return [x.clone() if x.data_ptr() % 16 else x for x in t]


def _check(hist: History, anchors, pu, q, w: Weights, *extra):
    src, ids, mask = hist
    if ids.dtype != torch.int32 or anchors.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("natr_attention takes int32 history and anchor ids and a bool mask")
    D = src.shape[1] if src.dim() == 2 else -1
    if (src.dim() != 2 or pu.dim() != 2 or q.dim() != 2 or pu.shape[1] != D
            or q.shape[1] != D or ids.dim() != 2 or mask.shape != ids.shape
            or anchors.dim() != 1 or pu.shape[0] != anchors.shape[0]):
        raise ValueError(f"natr_attention: src {tuple(src.shape)}, history {tuple(ids.shape)}, "
                         f"anchors {tuple(anchors.shape)}, pu {tuple(pu.shape)}, "
                         f"q {tuple(q.shape)}")
    want = {"W": (D, D), "b": (D,), "w_ua": (D, 1), "b_ua": (1,), "w_da": (D, 1),
            "b_da": (1,)}
    for name, t in w._asdict().items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"natr_attention: {name} {tuple(t.shape)}, want {want[name]}")
    on_card = _on_card("natr_attention", D, (src, pu, q, *w, *extra), (ids, mask, anchors))
    if on_card and smem_bytes(D, ids.shape[1]) > SMEM_LIMIT:
        raise ValueError(f"natr_attention: {ids.shape[1]} history slots at width {D} "
                         "exceed the kernel's shared memory")
    return on_card


def _args(hist: History, anchors, pu, q, w: Weights):
    """Pointers and sizes shared by the C entry points."""
    t = _aligned(hist.src, hist.ids, hist.mask, anchors, pu, q, *w)
    return t, [x.data_ptr() for x in t] + [hist.ids.shape[1], hist.src.shape[1]]


# --------------------------------------------------------------- wrappers

def natr_attention_forward(hist: History, anchors, pu, q, w: Weights):
    """float32 [P] logits of P pairs, pair p anchored at ``anchors[p]`` with
    ``pu[p]`` and queried by ``q[p]``."""
    if not _check(hist, anchors, pu, q, w):
        return natr_attention_forward_plain(hist, anchors, pu, q, w)
    if q.shape[0] != pu.shape[0]:
        raise ValueError("natr_attention_forward: one query per pair")
    keep, args = _args(hist, anchors, pu, q, w)
    P, D = pu.shape
    su = torch.empty(P, D, dtype=torch.float32, device=pu.device)
    out = torch.empty(P, dtype=torch.float32, device=pu.device)
    err = build.library("natr_attention").natr_attention_forward(
        *args, P, su.data_ptr(), out.data_ptr(), build.stream_handle(pu))
    build.check(err, "natr_attention_forward")
    natr_attention_forward.launches += 1
    return out


natr_attention_forward.launches = 0


def natr_attention_backward(hist: History, anchors, pu, q, w: Weights, g):
    """(dpu, dq, dW, db, dw_ua, db_ua, dw_da, db_da) from the gradient ``g``
    [P] of the logits. The weight gradients are sums over the pairs: each
    block of the kernel writes its partial sums and a second launch adds
    them in block order, so the result does not change from run to run."""
    if not _check(hist, anchors, pu, q, w, g):
        return natr_attention_backward_plain(hist, anchors, pu, q, w, g)
    if q.shape[0] != pu.shape[0] or g.shape != (pu.shape[0],):
        raise ValueError("natr_attention_backward: one query and one gradient per pair")
    keep, args = _args(hist, anchors, pu, q, w)
    g = g.contiguous()
    P, D = pu.shape
    dpu = torch.empty_like(keep[4])
    dq = torch.empty_like(keep[5])
    n_part = D * D + 3 * D + 2
    lib = build.library("natr_attention")
    blocks = lib.natr_attention_backward_blocks(D, hist.ids.shape[1], P)
    if blocks < 0:
        build.check(-blocks, "natr_attention_backward")
    partial = torch.empty(max(blocks, 1), n_part, dtype=torch.float32, device=pu.device)
    flat = torch.empty(n_part, dtype=torch.float32, device=pu.device)
    err = lib.natr_attention_backward(
        *args, P, g.data_ptr(), dpu.data_ptr(), dq.data_ptr(), partial.data_ptr(), blocks,
        flat.data_ptr(), build.stream_handle(pu))
    build.check(err, "natr_attention_backward")
    natr_attention_backward.launches += 1
    dW, db, dw_ua, db_ua, dw_da, db_da = torch.split(flat, [D * D, D, D, 1, D, 1])
    return (dpu, dq, dW.reshape(D, D), db, dw_ua.reshape(D, 1), db_ua,
            dw_da.reshape(D, 1), db_da)


natr_attention_backward.launches = 0


def natr_anchor_table(hist: History, anchors, pu, w: Weights):
    """su [A, D] of the anchors ``anchors`` (int32 [A]) with ``pu`` [A, D]:
    the anchor stage of every anchor in one launch over all SMs. A full-sort
    pass builds it once for every anchor row of the domain and gathers each
    tile's rows from it (``NATR.predict_grid``)."""
    if not _check(hist, anchors, pu, pu, w):
        return anchor_plain(hist, anchors, pu, w)
    keep, args = _args(hist, anchors, pu, pu, w)
    A, D = pu.shape
    su = torch.empty(A, D, dtype=torch.float32, device=pu.device)
    src, ids, mask, anchors_, pu_, _, W, b, w_ua, b_ua, _, _ = args[:12]
    err = build.library("natr_attention").natr_anchor_table(
        src, ids, mask, anchors_, pu_, W, b, w_ua, b_ua, hist.ids.shape[1], D, A,
        su.data_ptr(), build.stream_handle(pu))
    build.check(err, "natr_anchor_table")
    natr_anchor_table.launches += 1
    return su


natr_anchor_table.launches = 0


def natr_pair_grid(su, pu, q, w: Weights, anchor_is_row: bool):
    """float32 sigmoid probabilities of a grid, from the anchors' ``su`` and
    ``pu`` [A, D] and the queries ``q`` [Nq, D]: [A, Nq] with anchor ``a``
    on row a and query ``c`` on column c when ``anchor_is_row``, else [Nq, A]
    with the anchors on the columns."""
    D = q.shape[1] if q.dim() == 2 else -1
    if su.dim() != 2 or su.shape != pu.shape or q.dim() != 2 or su.shape[1] != D:
        raise ValueError(f"natr_pair_grid: su {tuple(su.shape)}, pu {tuple(pu.shape)}, "
                         f"q {tuple(q.shape)}")
    if not _on_card("natr_pair_grid", D, (su, pu, q, *w)):
        return pair_grid_plain(su, pu, q, w, anchor_is_row)
    keep = _aligned(su, pu, q, w.w_da, w.b_da)
    A, Nq = su.shape[0], q.shape[0]
    out = torch.empty((A, Nq) if anchor_is_row else (Nq, A), dtype=torch.float32,
                      device=su.device)
    err = build.library("natr_attention").natr_pair_grid(
        *(x.data_ptr() for x in keep), A, Nq, D, int(anchor_is_row), out.data_ptr(),
        build.stream_handle(su))
    build.check(err, "natr_pair_grid")
    natr_pair_grid.launches += 1
    return out


natr_pair_grid.launches = 0


def natr_full_sort(hist: History, anchors, pu, q, w: Weights, anchor_is_row: bool):
    """float32 sigmoid probabilities of a grid: [A, Nq] with anchor ``a`` on
    row a and query ``c`` on column c when ``anchor_is_row``, else [Nq, A]
    with the anchors on the columns. The anchor table of ``anchors``, then
    the pair grid: two launches, each counted by its own wrapper."""
    su = natr_anchor_table(hist, anchors, pu, w)
    return natr_pair_grid(su, pu, q, w, anchor_is_row)


class _NatrAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pu, q, W, b, w_ua, b_ua, w_da, b_da, hist, anchors):
        ctx.save_for_backward(pu, q, W, b, w_ua, b_ua, w_da, b_da)
        ctx.hist, ctx.anchors = hist, anchors
        return natr_attention_forward(hist, anchors, pu, q, Weights(W, b, w_ua, b_ua, w_da, b_da))

    @staticmethod
    def backward(ctx, g):
        pu, q, *w = ctx.saved_tensors
        grads = natr_attention_backward(ctx.hist, ctx.anchors, pu, q, Weights(*w),
                                        g.contiguous())
        return (*grads, None, None)


def natr_attention(hist: History, anchors, pu, q, w: Weights):
    """Differentiable logits [P]: gradients reach ``pu``, ``q`` and the
    weights, never the source table (pass it detached)."""
    if hist.src.requires_grad:
        raise ValueError("natr_attention takes no gradient for the source table: detach it")
    return _NatrAttention.apply(pu, q, *w, hist, anchors)
