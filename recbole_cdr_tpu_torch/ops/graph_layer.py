"""B8: one BiTGCF graph layer, forward and backward.

Port of ``recbole_cdr_tpu/models/bitgcf.py:116-123 BiTGCF._graph_layer`` and
its autodiff. With ``L`` the layer's normalised adjacency in CSR form
(:class:`CSR`) and ``x`` [N, D]:

- forward: ``side = L @ x``; ``new = x + side + x * side``; with dropout
  bits, ``new = where(mask, new / keep, 0)``;
- backward: ``g' = where(mask, g / keep, 0)``; ``gx = g' + g' * side +
  L^T @ (g' + g' * x)``, the product on the transpose's CSR.

The dropout mask comes from uint32 bits [N, D] (held as int32 bit patterns)
as JAX's ``bernoulli`` derives it from its uniform draw: ``u =
bitcast_f32((bits >> 9) | 0x3F800000) - 1``, ``mask = u < keep``; fed the
bits of ``jax.random.bits`` under the same key, the mask is JAX's.

Under ``compute_dtype: bfloat16`` every operand is 16-bit: ``x``, the CSR's
values (cast per call with the model's buffers; :func:`make_csr` keeps them
float32), the upstream gradient, and the outputs. The 16-bit form (B8-bf16,
float16 through the same template) sums each row in float32 and rounds where
JAX's value has a 16-bit type: ``side``, ``new`` (from the 16-bit ``x`` and
``side``), the dropout's ``new / keep``; in the backward ``g / keep``, ``h =
g' + g' x`` (the cotangent of ``side``) and ``gx``. The float32 form is the
same arithmetic with every rounding the identity.

The kernels are ``csrc/graph_layer.cu``; the plain versions below run for CPU
tensors and serve as the kernels' reference.
"""

from typing import NamedTuple

import numpy as np
import torch

from recbole_cdr_tpu_torch.ops import build


#: nonzeros per piece of the kernel's work (``csrc/graph_layer.cu``)
PIECE = 64
DTYPES = build.DTYPES


class CSR(NamedTuple):
    """A sparse [N, N] matrix, ``row_ptr`` int32 [N + 1], ``col`` int32
    [nnz], ``val`` float32 [nnz], and the kernel's schedule of it (made by
    :func:`make_csr`): each row is cut into pieces of at most ``PIECE``
    nonzeros, at least one per row; piece ``p`` covers row ``piece_row[p]``
    from nonzero ``piece_lo[p]``. A row of several pieces is "heavy": its
    pieces write partial sums to the slots ``piece_slot[p]`` (-1 for a light
    row's piece), and heavy row ``heavy_row[h]`` owns the slots
    ``heavy_ptr[h]`` to ``heavy_ptr[h + 1]``, in piece order."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    piece_row: torch.Tensor
    piece_lo: torch.Tensor
    piece_slot: torch.Tensor
    heavy_row: torch.Tensor
    heavy_ptr: torch.Tensor


def make_csr(row_ptr, col, val) -> CSR:
    """A :class:`CSR` with its schedule, on the device of ``row_ptr``."""
    dev = row_ptr.device
    n = row_ptr.shape[0] - 1
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    pieces = torch.clamp((deg + PIECE - 1) // PIECE, min=1)
    piece_row = torch.repeat_interleave(torch.arange(n, device=dev), pieces)
    first = torch.cumsum(pieces, 0) - pieces
    idx = torch.arange(piece_row.shape[0], device=dev) - first[piece_row]
    heavy = pieces > 1
    in_heavy = heavy[piece_row]
    slot = torch.where(in_heavy, torch.cumsum(in_heavy.long(), 0) - 1, -1)
    heavy_ptr = torch.zeros(int(heavy.sum()) + 1, dtype=torch.long, device=dev)
    torch.cumsum(pieces[heavy], 0, out=heavy_ptr[1:])
    i32 = lambda t: t.to(torch.int32).contiguous()
    return CSR(i32(row_ptr), i32(col), val.to(torch.float32).contiguous(), i32(piece_row),
               i32(row_ptr[piece_row].long() + idx * PIECE), i32(slot),
               i32(torch.nonzero(heavy).reshape(-1)), i32(heavy_ptr))


def csr_from_scipy(m) -> CSR:
    """The :class:`CSR` (on the CPU) of a scipy sparse matrix, columns sorted
    within each row."""
    m = m.tocsr()
    m.sort_indices()
    return make_csr(torch.from_numpy(m.indptr.astype(np.int32)),
                    torch.from_numpy(m.indices.astype(np.int32)),
                    torch.from_numpy(m.data.astype(np.float32)))


def keep_mask(bits, keep: float):
    """``u < keep`` with ``u`` the uniform float32 in [0, 1) of each uint32."""
    mant = torch.bitwise_or(torch.bitwise_and(bits >> 9, 0x7FFFFF), 0x3F800000)
    return (mant.view(torch.float32) - 1.0) < keep


def _spmm_plain(csr: CSR, x):
    """``L @ x`` in the working type: 16-bit values and rows widened to
    float32 and the products summed in float32."""
    wide = build.wide(x.dtype)
    rows = torch.repeat_interleave(
        torch.arange(csr.row_ptr.shape[0] - 1, device=x.device),
        (csr.row_ptr[1:] - csr.row_ptr[:-1]).long())
    out = torch.zeros(x.shape, dtype=wide, device=x.device)
    return out.index_add_(0, rows, csr.val.to(wide)[:, None] * x[csr.col.long()].to(wide))


def graph_layer_forward_plain(csr: CSR, x, bits, keep: float):
    """(new, side) in ``x``'s type."""
    r, xw = build.rounding(x.dtype), x.to(build.wide(x.dtype))
    side = r(_spmm_plain(csr, x))
    new = r(xw + side + xw * side)
    if bits is not None:
        new = torch.where(keep_mask(bits, keep), r(new / keep), 0.0)
    return new.to(x.dtype), side.to(x.dtype)


def _dropped_grad(g, bits, keep):
    return g if bits is None else torch.where(keep_mask(bits, keep), g / keep, 0.0)


def graph_layer_backward_plain(csr_t: CSR, x, side, bits, keep: float, g):
    """gx in ``x``'s type."""
    r, wide = build.rounding(x.dtype), build.wide(x.dtype)
    gp = r(_dropped_grad(g.to(wide), bits, keep))
    h = r(gp + gp * x.to(wide))
    return r((gp + gp * side.to(wide)) + _spmm_plain(csr_t, h)).to(x.dtype)


def _check(csr: CSR, x, bits, *dense, types=tuple(DTYPES)):
    if x.dtype not in types or x.dim() != 2:
        raise TypeError(f"graph_layer takes a [N, D] table of a type of {types}, got {x.dtype}")
    n = x.shape[0]
    if csr.row_ptr.dtype != torch.int32 or csr.col.dtype != torch.int32 \
            or csr.val.dtype != x.dtype:
        raise TypeError("graph_layer takes an int32 row_ptr and col and values of the "
                        f"table's type {x.dtype}, got {csr.val.dtype}")
    if csr.row_ptr.shape != (n + 1,) or csr.col.shape != csr.val.shape or csr.col.dim() != 1:
        raise ValueError(f"graph_layer: CSR of {csr.row_ptr.shape[0] - 1} rows, "
                         f"{csr.col.shape[0]} / {csr.val.shape[0]} nonzeros, for {n} rows")
    if bits is not None and (bits.dtype != torch.int32 or bits.shape != x.shape):
        raise ValueError("graph_layer: dropout bits must be int32 of the table's shape")
    if any(t.dtype != x.dtype or t.shape != x.shape for t in dense):
        raise ValueError("graph_layer: dense operands must be of the table's type and shape")
    if csr.piece_row.dtype != torch.int32 \
            or csr.heavy_ptr.shape != (csr.heavy_row.shape[0] + 1,):
        raise ValueError("graph_layer: the CSR has no schedule: build it with make_csr")
    tensors = (*csr, x, *dense) + ((bits,) if bits is not None else ())
    if len({t.device for t in tensors}) != 1:
        raise ValueError("graph_layer operands must share one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"graph_layer has no version for device {x.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _schedule_args(csr: CSR, D: int):
    """The C interface's schedule arguments, and the partial-sum scratch."""
    n_pieces, n_heavy = csr.piece_row.shape[0], csr.heavy_row.shape[0]
    # a light row has one piece and no slot: the slots are the other pieces
    slots = n_pieces - (csr.row_ptr.shape[0] - 1 - n_heavy)
    partial = torch.empty(slots, D, dtype=torch.float32, device=csr.val.device)
    args = [t.data_ptr() for t in csr] + [n_pieces, n_heavy, PIECE]
    return args, partial


def _forward(csr: CSR, x, bits, keep, name):
    x = x.contiguous()
    bits = None if bits is None else bits.contiguous()
    new, side = torch.empty_like(x), torch.empty_like(x)
    sched, partial = _schedule_args(csr, x.shape[1])
    err = build.library("graph_layer").graph_layer_forward(
        *sched, x.data_ptr(), _ptr(bits), float(np.float32(keep)), new.data_ptr(),
        side.data_ptr(), partial.data_ptr(), x.shape[0], x.shape[1], DTYPES[x.dtype],
        build.stream_handle(x),
    )
    build.check(err, name)
    return new, side


def _backward(csr_t: CSR, x, side, bits, keep, g, name):
    x, side, g = x.contiguous(), side.contiguous(), g.contiguous()
    bits = None if bits is None else bits.contiguous()
    h, gx = torch.empty_like(x), torch.empty_like(x)
    sched, partial = _schedule_args(csr_t, x.shape[1])
    err = build.library("graph_layer").graph_layer_backward(
        *sched, x.data_ptr(), side.data_ptr(), _ptr(bits), float(np.float32(keep)),
        g.data_ptr(), h.data_ptr(), gx.data_ptr(), partial.data_ptr(), x.shape[0],
        x.shape[1], DTYPES[x.dtype], build.stream_handle(x),
    )
    build.check(err, name)
    return gx


def graph_layer_forward(csr: CSR, x, bits=None, keep: float = 1.0):
    """(new, side) of one graph layer; ``bits`` None means no dropout. A
    16-bit table goes to :func:`graph_layer_forward_bf16`."""
    _check(csr, x, bits)
    if x.device.type == "cpu":
        return graph_layer_forward_plain(csr, x, bits, keep)
    if x.dtype != torch.float32:
        return graph_layer_forward_bf16(csr, x, bits, keep)
    out = _forward(csr, x, bits, keep, "graph_layer_forward")
    graph_layer_forward.launches += 1
    return out


graph_layer_forward.launches = 0


def graph_layer_forward_bf16(csr: CSR, x, bits=None, keep: float = 1.0):
    """B8's 16-bit form: a bfloat16 (or float16) table and CSR values, float32
    sums, (new, side) in the table's type."""
    _check(csr, x, bits, types=build.FLOAT16)
    if x.device.type == "cpu":
        return graph_layer_forward_plain(csr, x, bits, keep)
    out = _forward(csr, x, bits, keep, "graph_layer_forward_bf16")
    graph_layer_forward_bf16.launches += 1
    return out


graph_layer_forward_bf16.launches = 0


def graph_layer_backward(csr_t: CSR, x, side, bits, keep: float, g):
    """Gradient of the layer's input from the gradient ``g`` of its output;
    ``csr_t`` is the CSR of the adjacency's transpose. A 16-bit table goes
    to :func:`graph_layer_backward_bf16`."""
    _check(csr_t, x, bits, side, g)
    if x.device.type == "cpu":
        return graph_layer_backward_plain(csr_t, x, side, bits, keep, g)
    if x.dtype != torch.float32:
        return graph_layer_backward_bf16(csr_t, x, side, bits, keep, g)
    gx = _backward(csr_t, x, side, bits, keep, g, "graph_layer_backward")
    graph_layer_backward.launches += 1
    return gx


graph_layer_backward.launches = 0


def graph_layer_backward_bf16(csr_t: CSR, x, side, bits, keep: float, g):
    """B8's 16-bit backward: float32 sums, ``gx`` in the table's type."""
    _check(csr_t, x, bits, side, g, types=build.FLOAT16)
    if x.device.type == "cpu":
        return graph_layer_backward_plain(csr_t, x, side, bits, keep, g)
    gx = _backward(csr_t, x, side, bits, keep, g, "graph_layer_backward_bf16")
    graph_layer_backward_bf16.launches += 1
    return gx


graph_layer_backward_bf16.launches = 0


class _GraphLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, csr, csr_t, bits, keep):
        new, side = graph_layer_forward(csr, x, bits, keep)
        ctx.save_for_backward(x, side)
        ctx.csr_t, ctx.bits, ctx.keep = csr_t, bits, keep
        return new

    @staticmethod
    def backward(ctx, g):
        x, side = ctx.saved_tensors
        gx = graph_layer_backward(ctx.csr_t, x, side, ctx.bits, ctx.keep, g.contiguous())
        return gx, None, None, None, None


def graph_layer(x, csr: CSR, csr_t: CSR, bits=None, keep: float = 1.0):
    """Differentiable graph layer: ``x`` [N, D] -> new [N, D] in ``x``'s type
    (float32, bfloat16 or float16, the CSRs' values of the same type);
    ``bits`` None means no dropout, else int32 [N, D] bits and the keep
    probability."""
    return _GraphLayer.apply(x, csr, csr_t, bits, keep)
