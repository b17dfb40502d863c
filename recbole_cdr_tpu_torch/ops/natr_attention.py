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

- :func:`natr_attention_forward`: training, logits [P] of P pairs, each
  named by its anchor's id into the anchor side's table [N, D] (JAX's
  ``_phase2_logit`` gathers ``pu`` from it inside) and its query ``q``; on
  the card one anchor stage per distinct anchor of the step, from the plan
  of the anchor ids over the table's rows (``ops/row_groups.py::
  group_rows``, its own launch and count), and each source row transferred
  once (two kernels);
- :func:`natr_attention_backward`: the gradients of the anchor table (each
  row its pairs' terms added in position order, 0 where no pair names it),
  ``q``, ``W``, ``b``, ``w_ua``, ``b_ua``, ``w_da``, ``b_da`` (none for the
  source table, which NATR freezes in the phase that runs this; two
  kernels);
- :func:`natr_anchor_table`: ``su`` of a set of anchors, the anchor stage
  alone (full-sort scoring builds it once per parameter version);
- :func:`natr_pair_grid`: a [rows, cols] grid of sigmoid probabilities from
  the anchors' ``su`` and ``pu``, the anchors on the rows
  (``overlap_items``) or on the columns.

:func:`natr_full_sort` composes the last two.

Under ``compute_dtype: bfloat16`` every floating operand is 16-bit (the
source table, ``pu``, ``q``, the weights) and so is every output. The
16-bit forms (``*_bf16``, float16 through the same templates) accumulate
each dot and each sum over H or D in float32 and round to the operands'
type where JAX's bf16 ``_phase2_logit`` has a named intermediate: ``h``,
the masked attention logits (the mask's -10000 is -9984 in bf16), the
softmax, ``su``, ``b_s`` and ``b_p``, ``beta``, ``zu`` (per element), the
logit, and the grid's sigmoid. Their backward is the float32 chain rule on
those rounded values (a rounding passes its gradient through unchanged),
each gradient rounded once to the operands' type.

The kernels are ``csrc/natr_attention.cu``; the plain versions below run for
CPU tensors and serve as the kernels' reference (the plain backward is
autograd through the plain forward).
"""

from typing import NamedTuple

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.row_groups import RowPlan, group_rows

#: the kernels' widths (D = source width = target width), threads per block
#: and shared-memory budget
WIDTHS = (32, 64, 128)
DTYPES = build.DTYPES
THREADS = 256
SMEM_LIMIT = 227 * 1024
#: the table rows of one span of the training backward's counts (``kSpan``)
SPAN = 4 * THREADS


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

def _widen(*tensors):
    return [t.to(build.wide(t.dtype)) for t in tensors]


def _anchor(src, ids, mask, a, pu, w: Weights, r):
    he = r(src[ids[a].long()] @ w.W + w.b)                              # [A, H, D]
    att = (torch.relu(pu[:, None, :] * he) @ w.w_ua + w.b_ua).squeeze(-1)
    att = r(att + torch.where(mask[a], 0.0, -10000.0))
    att = r(torch.softmax(att, dim=1))
    return r(torch.einsum("bh,bhd->bd", att, he))


def _blend(su, pu, q, w: Weights, r):
    b_s = r(torch.relu(su * q) @ w.w_da + w.b_da)
    b_p = r(torch.relu(pu * q) @ w.w_da + w.b_da)
    beta = r(torch.exp(b_s) / (torch.exp(b_s) + torch.exp(b_p)))
    zu = r(beta * su + (1 - beta) * pu)
    return r((zu * q).sum(-1))


def anchor_plain(hist: History, anchors, pu, w: Weights):
    """su [A, D] of the anchors ``anchors`` (int32 [A]) with ``pu`` [A, D],
    in ``pu``'s type."""
    src, pu_w, *ws = _widen(hist.src, pu, *w)
    su = _anchor(src, hist.ids, hist.mask, anchors.long(), pu_w, Weights(*ws),
                 build.rounding(pu.dtype))
    return su.to(pu.dtype)


def blend_plain(su, pu, q, w: Weights):
    """Logits of the pair stage, in ``su``'s type; ``su``, ``pu`` and ``q``
    broadcast against each other over their leading dimensions."""
    dtype = su.dtype
    su, pu, q, *ws = _widen(su, pu, q, *w)
    return _blend(su, pu, q, Weights(*ws), build.rounding(dtype)).to(dtype)


def _forward_wide(hist: History, anchors, table, q, w: Weights, dtype):
    """The logits in the working type, from working-type ``table``, ``q``
    and weights, rounded as ``dtype`` computes. ``pu`` is gathered with
    ``F.embedding``, whose backward adds each row's terms in position order
    on every device."""
    r = build.rounding(dtype)
    pu = torch.nn.functional.embedding(anchors.long(), table)
    su = _anchor(hist.src.to(build.wide(dtype)), hist.ids, hist.mask, anchors.long(), pu, w, r)
    return _blend(su, pu, q, w, r)


def natr_attention_forward_plain(hist: History, table, anchors, q, w: Weights):
    table_w, q_w, *ws = _widen(table, q, *w)
    return _forward_wide(hist, anchors, table_w, q_w, Weights(*ws), table.dtype).to(table.dtype)


def natr_attention_backward_plain(hist: History, table, anchors, q, w: Weights, g):
    """(d table, dq, dW, db, dw_ua, db_ua, dw_da, db_da): autograd through
    the plain forward, each gradient rounded once to the operands' type."""
    dtype = table.dtype
    with torch.enable_grad():
        leaves = [t.detach().to(build.wide(dtype)).requires_grad_() for t in (table, q, *w)]
        logit = _forward_wide(hist, anchors, leaves[0], leaves[1], Weights(*leaves[2:]), dtype)
        grads = torch.autograd.grad(logit, leaves, g.to(logit.dtype), allow_unused=True)
    return tuple((torch.zeros_like(x) if d is None else d).to(dtype)
                 for x, d in zip(leaves, grads))


def pair_grid_plain(su, pu, q, w: Weights, anchor_is_row: bool):
    """Sigmoid probabilities of every (anchor, query) pair: [A, Nq] when
    ``anchor_is_row``, else [Nq, A], in ``su``'s type."""
    dtype, r = su.dtype, build.rounding(su.dtype)
    su, pu, q, *ws = _widen(su, pu, q, *w)
    if anchor_is_row:
        logit = _blend(su[:, None, :], pu[:, None, :], q[None, :, :], Weights(*ws), r)
    else:
        logit = _blend(su[None, :, :], pu[None, :, :], q[:, None, :], Weights(*ws), r)
    return r(torch.sigmoid(logit)).to(dtype)


def natr_full_sort_plain(hist: History, anchors, pu, q, w: Weights, anchor_is_row: bool):
    return pair_grid_plain(anchor_plain(hist, anchors, pu, w), pu, q, w, anchor_is_row)


# ---------------------------------------------------------------- checks

def smem_bytes(D: int, H: int) -> int:
    """The anchor table's kernel's dynamic shared memory for width D and H
    history slots (``csrc/natr_attention.cu::smem_bytes``: the transfer
    weight, the gathered history rows with a padded stride, the transferred
    rows, per-slot and per-width vectors); the wrappers refuse a history
    that does not fit it."""
    rows = 4 * THREADS // (D // 4)
    hp = -(-max(H, 1) // rows) * rows
    floats = D * D + hp * (D + 1) + hp * D + 2 * hp + 2 * D
    return 4 * floats + 4 * hp + hp


def _on_card(what: str, D: int, floats, others=(), types=tuple(DTYPES)) -> bool:
    """The checks every wrapper shares: ``floats`` all of one type of
    ``types``, every operand on one device, a device with a version, and on
    the card a width the kernels take. Returns whether the operands lie on
    the card."""
    if floats[0].dtype not in types or any(t.dtype != floats[0].dtype for t in floats):
        raise TypeError(f"{what} takes tables, embeddings and weights of one type of {types}, "
                        f"got {sorted({str(t.dtype) for t in floats})}")
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


def _check(hist: History, anchors, pu, q, w: Weights, *extra, types=tuple(DTYPES),
           table=None):
    """The operands' checks; ``table``: the training ops' anchor table [N,
    D], whose rows the anchors name (``pu`` then stands for it)."""
    src, ids, mask = hist
    if ids.dtype != torch.int32 or anchors.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("natr_attention takes int32 history and anchor ids and a bool mask")
    D = src.shape[1] if src.dim() == 2 else -1
    rows = pu.shape[0] if table is None else q.shape[0]
    if (src.dim() != 2 or pu.dim() != 2 or q.dim() != 2 or pu.shape[1] != D
            or q.shape[1] != D or ids.dim() != 2 or mask.shape != ids.shape
            or anchors.dim() != 1 or rows != anchors.shape[0]
            or (table is not None and ids.shape[0] < pu.shape[0])):
        raise ValueError(f"natr_attention: src {tuple(src.shape)}, history {tuple(ids.shape)}, "
                         f"anchors {tuple(anchors.shape)}, "
                         f"{'pu' if table is None else 'table'} {tuple(pu.shape)}, "
                         f"q {tuple(q.shape)}")
    want = {"W": (D, D), "b": (D,), "w_ua": (D, 1), "b_ua": (1,), "w_da": (D, 1),
            "b_da": (1,)}
    for name, t in w._asdict().items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"natr_attention: {name} {tuple(t.shape)}, want {want[name]}")
    on_card = _on_card("natr_attention", D, (src, pu, q, *w, *extra), (ids, mask, anchors),
                       types)
    if on_card and smem_bytes(D, ids.shape[1]) > SMEM_LIMIT:
        raise ValueError(f"natr_attention: {ids.shape[1]} history slots at width {D} "
                         "exceed the kernel's shared memory")
    return on_card


def _args(hist: History, anchors, pu, q, w: Weights):
    """Pointers and sizes shared by the C entry points."""
    t = _aligned(hist.src, hist.ids, hist.mask, anchors, pu, q, *w)
    return t, [x.data_ptr() for x in t] + [hist.ids.shape[1], hist.src.shape[1]]


# --------------------------------------------------------------- wrappers

class Kept(NamedTuple):
    """What the training forward keeps for its backward: the plan of the
    step's anchor ids and its ``generation`` at the forward, the transferred
    source table (float32 [Ns, D]), and per head ``su`` [P, D] and the
    softmax rounded and unrounded [P, H] (float32 values of the operands'
    type)."""

    plan: object
    generation: int
    transferred: torch.Tensor
    su: torch.Tensor
    att: torch.Tensor
    attq: torch.Tensor


def _check_plan(table, plan):
    """``plan`` must be the caller's ``RowPlan`` of the whole table's rows."""
    if (not isinstance(plan, RowPlan) or plan.L != table.shape[0] or plan.offset != 0
            or plan.device != table.device):
        raise ValueError("natr_attention: the plan must be a RowPlan of the anchor table's rows")


def _forward(hist: History, table, anchors, q, w: Weights, plan, name):
    """(logits, Kept) on the card: the plan, then the C entry."""
    groups = group_rows(anchors, plan)
    src, ids, mask, table, q, *ws = _aligned(hist.src, hist.ids, hist.mask, table, q, *w)
    (Ns, D), H, P = src.shape, ids.shape[1], q.shape[0]
    dev = q.device
    kept = Kept(plan, plan.generation, torch.empty(Ns, D, device=dev),
                torch.empty(P, D, device=dev), torch.empty(P, H, device=dev),
                torch.empty(P, H, device=dev))
    out = torch.empty(P, dtype=q.dtype, device=dev)
    err = build.library("natr_attention").natr_attention_forward(
        src.data_ptr(), Ns, ids.data_ptr(), mask.data_ptr(), H, D, table.data_ptr(),
        q.data_ptr(), *(x.data_ptr() for x in ws), groups.pointers(), P,
        *(x.data_ptr() for x in kept[2:]), out.data_ptr(), DTYPES[q.dtype],
        build.stream_handle(q))
    build.check(err, name)
    return out, kept


def natr_attention_forward(hist: History, table, anchors, q, w: Weights, plan):
    """[P] logits of P pairs, pair p anchored at row ``anchors[p]`` of the
    anchor side's ``table`` [N, D] (``pu`` = that row) and queried by
    ``q[p]``, in the operands' type; ``plan``: the ``RowPlan`` of the
    table's rows the caller keeps. 16-bit operands go to
    :func:`natr_attention_forward_bf16`."""
    return _forward_call(hist, table, anchors, q, w, plan)[0]


def _forward_call(hist, table, anchors, q, w, plan):
    """(logits, Kept or None on the CPU), counted by the form's wrapper."""
    _check_plan(table, plan)
    if not _check(hist, anchors, table, q, w, table=table):
        return natr_attention_forward_plain(hist, table, anchors, q, w), None
    if table.dtype != torch.float32:
        return _forward_bf16(hist, table, anchors, q, w, plan)
    out = _forward(hist, table, anchors, q, w, plan, "natr_attention_forward")
    natr_attention_forward.launches += 1
    return out


natr_attention_forward.launches = 0


def _forward_bf16(hist, table, anchors, q, w, plan):
    if not _check(hist, anchors, table, q, w, types=build.FLOAT16, table=table):
        return natr_attention_forward_plain(hist, table, anchors, q, w), None
    out = _forward(hist, table, anchors, q, w, plan, "natr_attention_forward_bf16")
    natr_attention_forward_bf16.launches += 1
    return out


def natr_attention_forward_bf16(hist: History, table, anchors, q, w: Weights, plan):
    """B9's 16-bit training forward: bfloat16 (or float16) operands, float32
    sums, logits rounded at JAX's bf16 intermediates."""
    _check_plan(table, plan)
    return _forward_bf16(hist, table, anchors, q, w, plan)[0]


natr_attention_forward_bf16.launches = 0


def _backward(hist: History, table, anchors, q, w: Weights, g, kept, name):
    """The gradients on the card, from the forward's ``kept`` values, whose
    plan must not have grouped other ids since."""
    if g.shape != (q.shape[0],):
        raise ValueError(f"{name}: one gradient per pair")
    if not isinstance(kept, Kept):
        raise ValueError(f"{name}: the card's backward takes the forward's kept values")
    if kept.plan.generation != kept.generation:
        raise ValueError(f"{name}: the forward's plan has grouped other ids since")
    src, ids, table, q, w_ua, w_da, b_da, g = _aligned(
        hist.src, hist.ids, table, q, w.w_ua, w.w_da, w.b_da, g)
    (N, D), H, P = table.shape, ids.shape[1], q.shape[0]
    dtable, dq = torch.empty_like(table), torch.empty_like(q)
    n_part = D * D + 3 * D + 2
    lib = build.library("natr_attention")
    blocks = lib.natr_attention_backward_blocks(D, H, N, DTYPES[q.dtype])
    if blocks < 0:
        build.check(-blocks, name)
    partial = torch.empty(max(blocks, 1), n_part, dtype=torch.float32, device=q.device)
    counts = torch.empty(max(-(-N // SPAN), 1), dtype=torch.int32, device=q.device)
    flat = torch.empty(n_part, dtype=q.dtype, device=q.device)
    err = lib.natr_attention_backward(
        src.data_ptr(), ids.data_ptr(), H, D, table.data_ptr(), N, q.data_ptr(),
        w_ua.data_ptr(), w_da.data_ptr(), b_da.data_ptr(), kept.plan.groups.pointers(),
        *(x.data_ptr() for x in kept[2:]), g.data_ptr(), dtable.data_ptr(), dq.data_ptr(),
        partial.data_ptr(), counts.data_ptr(), blocks, flat.data_ptr(), DTYPES[q.dtype],
        build.stream_handle(q))
    build.check(err, name)
    dW, db, dw_ua, db_ua, dw_da, db_da = torch.split(flat, [D * D, D, D, 1, D, 1])
    return (dtable, dq, dW.reshape(D, D), db, dw_ua.reshape(D, 1), db_ua,
            dw_da.reshape(D, 1), db_da)


def natr_attention_backward(hist: History, table, anchors, q, w: Weights, g, kept):
    """(d table, dq, dW, db, dw_ua, db_ua, dw_da, db_da) from the gradient
    ``g`` [P] of the logits, in the operands' type: a table row's gradient
    is its pairs' pair-stage terms added in position order plus its anchor
    stage's, once; 0 for a row no pair names. The weight gradients are sums
    over the heads: each block of the kernel writes its partial sums and a
    second launch adds them in block order, so the result does not change
    from run to run. ``kept``: the :class:`Kept` of the forward of these
    operands (:func:`_forward_call`'s; None on the CPU). 16-bit
    operands go to :func:`natr_attention_backward_bf16`."""
    if not _check(hist, anchors, table, q, w, g, table=table):
        return natr_attention_backward_plain(hist, table, anchors, q, w, g)
    if table.dtype != torch.float32:
        return natr_attention_backward_bf16(hist, table, anchors, q, w, g, kept)
    out = _backward(hist, table, anchors, q, w, g, kept, "natr_attention_backward")
    natr_attention_backward.launches += 1
    return out


natr_attention_backward.launches = 0


def natr_attention_backward_bf16(hist: History, table, anchors, q, w: Weights, g, kept):
    """B9's 16-bit backward: the float32 chain rule on the forward's rounded
    values, float32 partial sums, each gradient rounded once."""
    if not _check(hist, anchors, table, q, w, g, types=build.FLOAT16, table=table):
        return natr_attention_backward_plain(hist, table, anchors, q, w, g)
    out = _backward(hist, table, anchors, q, w, g, kept, "natr_attention_backward_bf16")
    natr_attention_backward_bf16.launches += 1
    return out


natr_attention_backward_bf16.launches = 0


def _anchor_table(hist: History, anchors, pu, w: Weights, name):
    keep, args = _args(hist, anchors, pu, pu, w)
    A, D = pu.shape
    su = torch.empty(A, D, dtype=pu.dtype, device=pu.device)
    src, ids, mask, anchors_, pu_, _, W, b, w_ua, b_ua, _, _ = args[:12]
    err = build.library("natr_attention").natr_anchor_table(
        src, ids, mask, anchors_, pu_, W, b, w_ua, b_ua, hist.ids.shape[1], D, A,
        su.data_ptr(), DTYPES[pu.dtype], build.stream_handle(pu))
    build.check(err, name)
    return su


def natr_anchor_table(hist: History, anchors, pu, w: Weights):
    """su [A, D] of the anchors ``anchors`` (int32 [A]) with ``pu`` [A, D]:
    the anchor stage of every anchor in one launch over all SMs. A full-sort
    pass builds it once for every anchor row of the domain and gathers each
    tile's rows from it (``NATR.predict_grid``). 16-bit operands go to
    :func:`natr_anchor_table_bf16`."""
    if not _check(hist, anchors, pu, pu, w):
        return anchor_plain(hist, anchors, pu, w)
    if pu.dtype != torch.float32:
        return natr_anchor_table_bf16(hist, anchors, pu, w)
    su = _anchor_table(hist, anchors, pu, w, "natr_anchor_table")
    natr_anchor_table.launches += 1
    return su


natr_anchor_table.launches = 0


def natr_anchor_table_bf16(hist: History, anchors, pu, w: Weights):
    """B9's 16-bit anchor table: ``su`` in the operands' type."""
    if not _check(hist, anchors, pu, pu, w, types=build.FLOAT16):
        return anchor_plain(hist, anchors, pu, w)
    su = _anchor_table(hist, anchors, pu, w, "natr_anchor_table_bf16")
    natr_anchor_table_bf16.launches += 1
    return su


natr_anchor_table_bf16.launches = 0


def _check_grid(su, pu, q, w: Weights, types):
    D = q.shape[1] if q.dim() == 2 else -1
    if su.dim() != 2 or su.shape != pu.shape or q.dim() != 2 or su.shape[1] != D:
        raise ValueError(f"natr_pair_grid: su {tuple(su.shape)}, pu {tuple(pu.shape)}, "
                         f"q {tuple(q.shape)}")
    return _on_card("natr_pair_grid", D, (su, pu, q, *w), types=types)


def _pair_grid(su, pu, q, w: Weights, anchor_is_row: bool, name):
    keep = _aligned(su, pu, q, w.w_da, w.b_da)
    A, Nq, D = su.shape[0], q.shape[0], q.shape[1]
    out = torch.empty((A, Nq) if anchor_is_row else (Nq, A), dtype=su.dtype, device=su.device)
    err = build.library("natr_attention").natr_pair_grid(
        *(x.data_ptr() for x in keep), A, Nq, D, int(anchor_is_row), out.data_ptr(),
        DTYPES[su.dtype], build.stream_handle(su))
    build.check(err, name)
    return out


def natr_pair_grid(su, pu, q, w: Weights, anchor_is_row: bool):
    """Sigmoid probabilities of a grid in the operands' type, from the
    anchors' ``su`` and ``pu`` [A, D] and the queries ``q`` [Nq, D]: [A, Nq]
    with anchor ``a`` on row a and query ``c`` on column c when
    ``anchor_is_row``, else [Nq, A] with the anchors on the columns. 16-bit
    operands go to :func:`natr_pair_grid_bf16`."""
    if not _check_grid(su, pu, q, w, tuple(DTYPES)):
        return pair_grid_plain(su, pu, q, w, anchor_is_row)
    if su.dtype != torch.float32:
        return natr_pair_grid_bf16(su, pu, q, w, anchor_is_row)
    out = _pair_grid(su, pu, q, w, anchor_is_row, "natr_pair_grid")
    natr_pair_grid.launches += 1
    return out


natr_pair_grid.launches = 0


def natr_pair_grid_bf16(su, pu, q, w: Weights, anchor_is_row: bool):
    """B9's 16-bit pair grid: gates, then the blend with ``zu`` rounded per
    element, the logit and its sigmoid rounded to the operands' type."""
    if not _check_grid(su, pu, q, w, build.FLOAT16):
        return pair_grid_plain(su, pu, q, w, anchor_is_row)
    out = _pair_grid(su, pu, q, w, anchor_is_row, "natr_pair_grid_bf16")
    natr_pair_grid_bf16.launches += 1
    return out


natr_pair_grid_bf16.launches = 0


def natr_full_sort(hist: History, anchors, pu, q, w: Weights, anchor_is_row: bool):
    """Sigmoid probabilities of a grid in the operands' type: [A, Nq] with anchor ``a`` on
    row a and query ``c`` on column c when ``anchor_is_row``, else [Nq, A]
    with the anchors on the columns. The anchor table of ``anchors``, then
    the pair grid: two launches, each counted by its own wrapper."""
    su = natr_anchor_table(hist, anchors, pu, w)
    return natr_pair_grid(su, pu, q, w, anchor_is_row)


class _NatrAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, q, W, b, w_ua, b_ua, w_da, b_da, hist, anchors, plan):
        w = Weights(W, b, w_ua, b_ua, w_da, b_da)
        out, ctx.kept = _forward_call(hist, table, anchors, q, w, plan)
        ctx.save_for_backward(table, q, W, b, w_ua, b_ua, w_da, b_da)
        ctx.hist, ctx.anchors = hist, anchors
        return out

    @staticmethod
    def backward(ctx, g):
        table, q, *w = ctx.saved_tensors
        grads = natr_attention_backward(ctx.hist, table, ctx.anchors, q, Weights(*w),
                                        g.contiguous(), ctx.kept)
        ctx.kept = None
        return (*grads, None, None, None)


def natr_attention(hist: History, table, anchors, q, w: Weights, plan):
    """Differentiable logits [P] of the pairs (row ``anchors[p]`` of
    ``table``, ``q[p]``): gradients reach ``table``, ``q`` and the weights,
    never the source table (pass it detached). ``plan``: the ``RowPlan`` of
    the table's rows the caller keeps; the forward's grouping and its
    anchor stages serve the backward."""
    if hist.src.requires_grad:
        raise ValueError("natr_attention takes no gradient for the source table: detach it")
    return _NatrAttention.apply(table, q, *w, hist, anchors, plan)
