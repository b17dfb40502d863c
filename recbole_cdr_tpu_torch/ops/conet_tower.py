"""B15: CoNet's full-sort tower.

Port of ``recbole_cdr_tpu/models/conet.py:150-169 CoNet.full_sort_fn``.
The target tower's first layer on ``[user_e || item_e]`` splits into a user
half ``hu = user_e @ W_u`` [B, H0], an item half ``hi = item_e @ W_i`` [I,
H0] and the layer's bias ``b0`` [H0]; for every (user, item) of a tile the
kernel takes

    h = relu((hu[b] + hi[i]) + b0),  h = relu(h @ W_l + b_l) for the later layers,
    out[b, i] = sigmoid(h @ w_out + b_out)

and writes only the [B, I] probabilities: no [B, I, H0] hidden exists in
device memory (``csrc/conet_tower.cu``). :func:`conet_tower` counts its
calls that launch. The plain version runs the same chain in torch over item
chunks of at most ``PAIR_BUDGET`` pairs, for CPU tensors and as the
kernel's reference.

The kernel runs the products on the tensor cores with the hidden in
registers (3xTF32 in float32). It takes towers of up to ``MAX_LAYERS``
products after the first layer, every width at most ``MAX_WIDTH``; the
wrapper pads every product's input width to a multiple of 16 and the last
width to 8 with zero weights (:func:`padded_tower`; a padded unit's relu is
0) and raises on the card beyond those limits.

Under ``compute_dtype: bfloat16`` the halves and the weights are 16-bit and
so are the probabilities, as JAX's bf16 ``full_sort`` returns them. The
16-bit form (:func:`conet_tower_bf16`, float16 through the same template)
sums in float32 and rounds to the operands' type where JAX's value has a
name: ``hu + hi``, then its sum with ``b0`` (JAX's order), each later
layer's ``h @ W + b``, the logit and the sigmoid.
"""

import torch
import torch.nn.functional as F

from recbole_cdr_tpu_torch.ops import build
MAX_LAYERS = 5
MAX_WIDTH = 128
#: max (user, item) pairs of one chunk of the plain version (the predict
#: fallback's budget, ``models/base.py::CrossDomainRecommender.PAIR_BUDGET``)
PAIR_BUDGET = 1 << 18


def conet_tower_plain(hu, hi, b0, layers, out_layer):
    """[B, I] probabilities of the tower in the operands' type, item chunk by
    item chunk (in float32 for 16-bit operands, rounded as they compute)."""
    B, I = hu.shape[0], hi.shape[0]
    dtype, r = hu.dtype, build.rounding(hu.dtype)
    hu, hi, b0 = (t.to(build.wide(dtype)) for t in (hu, hi, b0))
    layers = [(W.to(hu.dtype), b.to(hu.dtype)) for W, b in layers]
    w_out, b_out = (t.to(hu.dtype) for t in out_layer)
    chunk = max(1, PAIR_BUDGET // max(B, 1))
    parts = [torch.zeros(B, 0, dtype=dtype, device=hu.device)]
    for lo in range(0, I, chunk):
        h = torch.relu(r(r(hu[:, None, :] + hi[None, lo:lo + chunk, :]) + b0))
        for W, b in layers:
            h = torch.relu(r(h @ W + b))
        parts.append(r(torch.sigmoid(r(h @ w_out + b_out).squeeze(-1))).to(dtype))
    return torch.cat(parts, 1)


def tower_widths(dims):
    """The kernel's widths of a tower of ``dims`` (H0, then each product's
    output): every product's input padded to a multiple of 16 (the k of an
    m16n8k16 product, two of TF32's k8), the last width to 8 (an n-tile)."""
    units = [16] * (len(dims) - 1) + [8]
    return [-(-d // u) * u for d, u in zip(dims, units)]


def padded_tower(hu, hi, b0, layers, out_layer):
    """The operands zero-padded to :func:`tower_widths`: a padded unit's
    relu is 0 and its weights are 0, so the tower is unchanged."""
    widths = tower_widths([hu.shape[1]] + [W.shape[1] for W, _ in layers])

    def pad(t, cols, rows=None):  # no copy where nothing is padded
        pads = (0, cols - t.shape[-1]) + (() if rows is None else (0, rows - t.shape[0]))
        return F.pad(t, pads) if any(pads) else t

    hu, hi, b0 = (pad(t, widths[0]) for t in (hu, hi, b0))
    layers = [(pad(W, b, a), pad(bias, b)) for (W, bias), a, b in zip(layers, widths, widths[1:])]
    w_out, b_out = out_layer
    return hu, hi, b0, layers, (pad(w_out, 1, widths[-1]), b_out)


def packed_weights(layers, out_layer):
    """One buffer of the weights (already padded, :func:`padded_tower`) in
    their type: per layer ``W`` [w_l, w_{l+1}] then ``b``, then ``w_out`` and
    ``b_out``, as ``csrc/conet_tower.cu`` reads them."""
    parts = [t.reshape(-1) for W, b in layers for t in (W, b)]
    parts += [out_layer[0].reshape(-1), out_layer[1].reshape(-1)]
    return torch.cat(parts).contiguous()


def _check(hu, hi, b0, layers, out_layer, types=tuple(build.DTYPES)) -> bool:
    tensors = [hu, hi, b0, *(t for layer in layers for t in layer), *out_layer]
    if hu.dtype not in types or any(t.dtype != hu.dtype for t in tensors):
        raise TypeError(f"conet_tower takes halves and weights of one type of {types}, "
                        f"got {sorted({str(t.dtype) for t in tensors})}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("conet_tower operands must share one device")
    dims = [hu.shape[-1]]
    for W, b in layers:
        if W.dim() != 2 or W.shape[0] != dims[-1] or b.shape != (W.shape[1],):
            raise ValueError(f"conet_tower: layer {tuple(W.shape)} after width {dims[-1]}")
        dims.append(W.shape[1])
    w_out, b_out = out_layer
    if (hu.dim() != 2 or hi.dim() != 2 or hi.shape[1] != hu.shape[1]
            or b0.shape != (hu.shape[1],) or w_out.shape != (dims[-1], 1)
            or b_out.shape != (1,)):
        raise ValueError(f"conet_tower: hu {tuple(hu.shape)}, hi {tuple(hi.shape)}, "
                         f"b0 {tuple(b0.shape)}, out {tuple(w_out.shape)}")
    dev = hu.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"conet_tower has no version for device {hu.device}")
    if dev == "cuda" and (len(layers) > MAX_LAYERS or max(dims) > MAX_WIDTH):
        raise ValueError(f"conet_tower: the kernel takes up to {MAX_LAYERS} layers after the "
                         f"first, each at most {MAX_WIDTH} wide; got widths {dims}")
    return dev == "cuda"


def _tower(hu, hi, b0, layers, out_layer, name):
    hu, hi, b0, layers, out_layer = padded_tower(hu, hi, b0, layers, out_layer)
    hu, hi, b0 = hu.contiguous(), hi.contiguous(), b0.contiguous()
    if hi.data_ptr() % 16:  # the kernel copies hi's rows in 16-byte pieces
        hi = hi.clone()
    weights = packed_weights(layers, out_layer)
    widths = [hu.shape[1]] + [W.shape[1] for W, _ in layers]
    B, I = hu.shape[0], hi.shape[0]
    out = torch.empty(B, I, dtype=hu.dtype, device=hu.device)
    args = widths + [0] * (MAX_LAYERS + 1 - len(widths))
    err = build.library("conet_tower").conet_tower(
        hu.data_ptr(), hi.data_ptr(), b0.data_ptr(), B, I, weights.data_ptr(), len(layers),
        *args, out.data_ptr(), build.DTYPES[hu.dtype], build.stream_handle(hu))
    build.check(err, name)
    return out


def conet_tower(hu, hi, b0, layers, out_layer):
    """[B, I] sigmoid probabilities of every (user b, item i) from the user
    half ``hu`` [B, H0], the item half ``hi`` [I, H0], the first layer's bias
    ``b0`` [H0], the later layers
    ``[(W [d_in, d_out], b [d_out]), ...]`` and the output layer ``(w_out
    [d_last, 1], b_out [1])``, in the operands' type; 16-bit operands go to
    :func:`conet_tower_bf16`."""
    if not _check(hu, hi, b0, layers, out_layer):
        return conet_tower_plain(hu, hi, b0, layers, out_layer)
    if hu.dtype != torch.float32:
        return conet_tower_bf16(hu, hi, b0, layers, out_layer)
    out = _tower(hu, hi, b0, layers, out_layer, "conet_tower")
    conet_tower.launches += 1
    return out


conet_tower.launches = 0


def conet_tower_bf16(hu, hi, b0, layers, out_layer):
    """B15's 16-bit form: bfloat16 (or float16) halves and weights, the
    products on the 16-bit tensor cores with float32 sums, every layer
    rounded to the operands' type, 16-bit probabilities."""
    if not _check(hu, hi, b0, layers, out_layer, build.FLOAT16):
        return conet_tower_plain(hu, hi, b0, layers, out_layer)
    out = _tower(hu, hi, b0, layers, out_layer, "conet_tower_bf16")
    conet_tower_bf16.launches += 1
    return out


conet_tower_bf16.launches = 0
