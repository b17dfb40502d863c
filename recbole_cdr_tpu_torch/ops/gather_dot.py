"""K1: pairwise gather-dot score with a scatter-add backward.

Port of ``recbole_cdr_tpu/models/cmf.py:45-48 CMF._score`` and its autodiff:
``s[b] = <U[u_b], I[i_b]>``; the backward adds ``g_b * I[i_b]`` into row
``u_b`` of a dense ``dU`` and ``g_b * U[u_b]`` into row ``i_b`` of ``dI``.
The kernels are ``csrc/gather_dot.cu``: a float32 form, and a 16-bit form
(K1-bf16) for the tables of a ``compute_dtype: bfloat16`` step, which loads
the 16-bit rows, multiplies and sums in float32 and writes the score in the
tables' type (JAX's bf16 product, which feeds ``weighted_mean``'s upcast);
its backward accumulates in float32 and returns the gradients in the
tables' type. The plain versions below run for CPU tensors and serve as the
kernels' reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build


#: the table types of the kernels and their C type codes: float32, and the
#: 16-bit form (K1-bf16, float16 through the same template) that loads
#: 16-bit rows, multiplies and sums in float32 and rounds the score once to
#: the tables' type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gather_dot_plain(U, I, u, i):
    """The kernels' arithmetic: products and sum in float32, the score in
    the tables' type."""
    return (U[u.long()].float() * I[i.long()].float()).sum(-1).to(U.dtype)


def gather_dot_backward_plain(U, I, u, i, g):
    """Row gradients summed in float32, returned in the tables' type."""
    u, i, g = u.long(), i.long(), g.float()
    dU = torch.zeros(U.shape, device=U.device).index_add_(0, u, g[:, None] * I[i].float())
    dI = torch.zeros(I.shape, device=I.device).index_add_(0, i, g[:, None] * U[u].float())
    return dU.to(U.dtype), dI.to(I.dtype)


def _check(U, I, u, i, g=None):
    if U.dtype not in DTYPES or I.dtype != U.dtype:
        raise TypeError(f"gather_dot takes two tables of one type of {tuple(DTYPES)}: "
                        f"{U.dtype}, {I.dtype}")
    if U.dim() != 2 or I.dim() != 2 or U.shape[1] != I.shape[1]:
        raise ValueError(f"gather_dot tables must be [N, D] with one D: {U.shape}, {I.shape}")
    if u.dtype != torch.int32 or i.dtype != torch.int32:
        raise TypeError("gather_dot takes int32 ids")
    if u.dim() != 1 or u.shape != i.shape:
        raise ValueError(f"gather_dot ids must be 1-D and aligned: {u.shape}, {i.shape}")
    if len({t.device for t in (U, I, u, i)}) != 1:
        raise ValueError("gather_dot operands must share one device")
    if U.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_dot has no version for device {U.device}")
    if g is not None and (g.dtype != U.dtype or g.shape != u.shape or g.device != U.device):
        raise ValueError("gather_dot backward takes a gradient per pair in the tables' type")


def _forward(U, I, u, i, name):
    U, I, u, i = (t.contiguous() for t in (U, I, u, i))
    out = torch.empty(u.shape[0], dtype=U.dtype, device=U.device)
    err = build.library("gather_dot").gather_dot_forward(
        U.data_ptr(), I.data_ptr(), u.data_ptr(), i.data_ptr(), out.data_ptr(),
        u.shape[0], U.shape[1], DTYPES[U.dtype], build.stream_handle(U),
    )
    build.check(err, name)
    return out


def _backward(U, I, u, i, g, name):
    """The kernel adds into zeroed float32 tables; 16-bit tables get them
    rounded once to their type."""
    U, I, u, i, g = (t.contiguous() for t in (U, I, u, i, g))
    dU = torch.zeros(U.shape, dtype=torch.float32, device=U.device)
    dI = torch.zeros(I.shape, dtype=torch.float32, device=I.device)
    err = build.library("gather_dot").gather_dot_backward(
        U.data_ptr(), I.data_ptr(), u.data_ptr(), i.data_ptr(), g.data_ptr(),
        dU.data_ptr(), dI.data_ptr(), u.shape[0], U.shape[1], DTYPES[U.dtype],
        build.stream_handle(U),
    )
    build.check(err, name)
    return dU.to(U.dtype), dI.to(I.dtype)


def gather_dot_forward(U, I, u, i):
    """Scores ``(U[u] * I[i]).sum(-1)`` in the tables' type; 16-bit tables
    go to :func:`gather_dot_forward_bf16`."""
    _check(U, I, u, i)
    if U.device.type == "cpu":
        return gather_dot_plain(U, I, u, i)
    if U.dtype != torch.float32:
        return gather_dot_forward_bf16(U, I, u, i)
    out = _forward(U, I, u, i, "gather_dot_forward")
    gather_dot_forward.launches += 1
    return out


gather_dot_forward.launches = 0


def gather_dot_forward_bf16(U, I, u, i):
    """K1's 16-bit form: bfloat16 (or float16) tables, float32 products and
    sum, the score rounded once to the tables' type."""
    _check(U, I, u, i)
    if U.dtype == torch.float32:
        raise TypeError("gather_dot_forward_bf16 takes 16-bit tables")
    if U.device.type == "cpu":
        return gather_dot_plain(U, I, u, i)
    out = _forward(U, I, u, i, "gather_dot_forward_bf16")
    gather_dot_forward_bf16.launches += 1
    return out


gather_dot_forward_bf16.launches = 0


def gather_dot_backward(U, I, u, i, g):
    """(dU, dI) in the tables' type; 16-bit tables go to
    :func:`gather_dot_backward_bf16`."""
    _check(U, I, u, i, g)
    if U.device.type == "cpu":
        return gather_dot_backward_plain(U, I, u, i, g)
    if U.dtype != torch.float32:
        return gather_dot_backward_bf16(U, I, u, i, g)
    out = _backward(U, I, u, i, g, "gather_dot_backward")
    gather_dot_backward.launches += 1
    return out


gather_dot_backward.launches = 0


def gather_dot_backward_bf16(U, I, u, i, g):
    """K1's 16-bit backward: the row gradients added into float32 tables by
    atomics, then rounded once to the tables' type."""
    _check(U, I, u, i, g)
    if U.dtype == torch.float32:
        raise TypeError("gather_dot_backward_bf16 takes 16-bit tables")
    if U.device.type == "cpu":
        return gather_dot_backward_plain(U, I, u, i, g)
    out = _backward(U, I, u, i, g, "gather_dot_backward_bf16")
    gather_dot_backward_bf16.launches += 1
    return out


gather_dot_backward_bf16.launches = 0


class _GatherDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, I, u, i):
        ctx.save_for_backward(U, I, u, i)
        return gather_dot_forward(U, I, u, i)

    @staticmethod
    def backward(ctx, g):
        U, I, u, i = ctx.saved_tensors
        dU, dI = gather_dot_backward(U, I, u, i, g.contiguous())
        return dU, dI, None, None


def gather_dot(U, I, u, i):
    """Differentiable ``(U[u] * I[i]).sum(-1)`` for int32 ids ``u``, ``i``
    and float32, bfloat16 or float16 tables."""
    return _GatherDot.apply(U, I, u, i)
