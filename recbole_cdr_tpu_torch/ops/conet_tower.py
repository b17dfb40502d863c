"""B15: CoNet's full-sort tower.

Port of ``recbole_cdr_tpu/models/conet.py:150-169 CoNet.full_sort_fn``.
The target tower's first layer on ``[user_e || item_e]`` splits into a user
half ``hu = user_e @ W_u + b0`` [B, H0] and an item half ``hi = item_e @
W_i`` [I, H0]; for every (user, item) of a tile the kernel takes

    h = relu(hu[b] + hi[i]),  h = relu(h @ W_l + b_l) for the later layers,
    out[b, i] = sigmoid(h @ w_out + b_out)

and writes only the [B, I] probabilities: no [B, I, H0] hidden exists in
device memory (``csrc/conet_tower.cu``). :func:`conet_tower` counts its
calls that launch. The plain version runs the same chain in torch over item
chunks of at most ``PAIR_BUDGET`` pairs, for CPU tensors and as the
kernel's reference.

The kernel takes towers of up to ``MAX_LAYERS`` products after the first
layer, every width at most ``MAX_WIDTH``; the wrapper pads each width to a
multiple of 4 with zero weights (a padded unit's relu is 0) and raises on
the card beyond those limits.
"""

import torch
import torch.nn.functional as F

from recbole_cdr_tpu_torch.ops import build

MAX_LAYERS = 5
MAX_WIDTH = 128
#: max (user, item) pairs of one chunk of the plain version (the predict
#: fallback's budget, ``models/base.py::CrossDomainRecommender.PAIR_BUDGET``)
PAIR_BUDGET = 1 << 18


def conet_tower_plain(hu, hi, layers, out_layer):
    """[B, I] probabilities of the tower, item chunk by item chunk."""
    B, I = hu.shape[0], hi.shape[0]
    w_out, b_out = out_layer
    chunk = max(1, PAIR_BUDGET // max(B, 1))
    parts = [torch.zeros(B, 0, dtype=hu.dtype, device=hu.device)]
    for lo in range(0, I, chunk):
        h = torch.relu(hu[:, None, :] + hi[None, lo:lo + chunk, :])
        for W, b in layers:
            h = torch.relu(h @ W + b)
        parts.append(torch.sigmoid((h @ w_out + b_out).squeeze(-1)))
    return torch.cat(parts, 1)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def packed_weights(layers, out_layer):
    """(one float32 buffer of the padded weights, the padded widths): per
    layer ``W`` [w_l, w_{l+1}] then ``b``, then ``w_out`` and ``b_out`` padded
    to 4, as ``csrc/conet_tower.cu`` reads them."""
    parts, widths = [], []
    for W, b in layers:
        d_in, d_out = _pad4(W.shape[0]), _pad4(W.shape[1])
        widths.append(d_in)
        parts += [F.pad(W, (0, d_out - W.shape[1], 0, d_in - W.shape[0])).reshape(-1),
                  F.pad(b, (0, d_out - b.shape[0]))]
    w_out, b_out = out_layer
    widths.append(_pad4(w_out.shape[0]))
    parts += [F.pad(w_out.reshape(-1), (0, widths[-1] - w_out.shape[0])), F.pad(b_out, (0, 3))]
    return torch.cat(parts).contiguous(), widths


def _check(hu, hi, layers, out_layer) -> bool:
    tensors = [hu, hi, *(t for layer in layers for t in layer), *out_layer]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("conet_tower takes float32 halves and weights")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("conet_tower operands must share one device")
    dims = [hu.shape[-1]]
    for W, b in layers:
        if W.dim() != 2 or W.shape[0] != dims[-1] or b.shape != (W.shape[1],):
            raise ValueError(f"conet_tower: layer {tuple(W.shape)} after width {dims[-1]}")
        dims.append(W.shape[1])
    w_out, b_out = out_layer
    if (hu.dim() != 2 or hi.dim() != 2 or hi.shape[1] != hu.shape[1]
            or w_out.shape != (dims[-1], 1) or b_out.shape != (1,)):
        raise ValueError(f"conet_tower: hu {tuple(hu.shape)}, hi {tuple(hi.shape)}, "
                         f"out {tuple(w_out.shape)}")
    dev = hu.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"conet_tower has no version for device {hu.device}")
    if dev == "cuda" and (len(layers) > MAX_LAYERS or max(dims) > MAX_WIDTH):
        raise ValueError(f"conet_tower: the kernel takes up to {MAX_LAYERS} layers after the "
                         f"first, each at most {MAX_WIDTH} wide; got widths {dims}")
    return dev == "cuda"


def conet_tower(hu, hi, layers, out_layer):
    """float32 [B, I] sigmoid probabilities of every (user b, item i) from
    the user half ``hu`` [B, H0], the item half ``hi`` [I, H0], the later
    layers ``[(W [d_in, d_out], b [d_out]), ...]`` and the output layer
    ``(w_out [d_last, 1], b_out [1])``."""
    if not _check(hu, hi, layers, out_layer):
        return conet_tower_plain(hu, hi, layers, out_layer)
    H0 = _pad4(hu.shape[1])
    hu = F.pad(hu, (0, H0 - hu.shape[1])).contiguous()
    hi = F.pad(hi, (0, H0 - hi.shape[1])).contiguous()
    weights, widths = packed_weights(layers, out_layer)  # widths[0] == H0
    B, I = hu.shape[0], hi.shape[0]
    out = torch.empty(B, I, dtype=torch.float32, device=hu.device)
    args = widths + [0] * (MAX_LAYERS + 1 - len(widths))
    err = build.library("conet_tower").conet_tower(
        hu.data_ptr(), hi.data_ptr(), B, I, weights.data_ptr(), len(layers), *args,
        out.data_ptr(), build.stream_handle(hu))
    build.check(err, "conet_tower")
    conet_tower.launches += 1
    return out


conet_tower.launches = 0
