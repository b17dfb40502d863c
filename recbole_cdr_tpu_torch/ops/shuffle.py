"""B3: one epoch stream of the device loop (the swap-or-not epoch shuffle
and the gathers of its rows) in one launch.

Port of the stream of ``recbole_cdr_tpu/trainer/device_loop.py``:
``domain_stream`` up to the negatives (``:483-518``) and the OVERLAP stream
(``:560-570``), around ``:63-88 _swap_or_not``. Slot t of steps
``[step_lo, step_lo + n_steps)`` of ``dstep`` slots is slot ``s * dstep + t
% dstep`` of one permutation, s = ``step_lo + t // dstep``, or, when the
source cycles (``per_cycle`` batches a cycle), slot ``(s % per_cycle) *
dstep + t % dstep`` of cycle ``s // per_cycle``'s own permutation (its key
row); a slot is valid below ``n`` and an invalid one stands in as slot 0.
The keyed bijection on [0, n): round r pairs x with ``partner = (K_r - x)
mod n`` and swaps iff the low bit of the murmur3 finalizer of ``max(x,
partner) ^ salt_r`` is set; every round is an involution, so 64 rounds
compose to an exact permutation for any n (and give 0 for n <= 1). The
stream is each column of a table at the permuted rows (a domain's users and
items side by side, or the overlapped ids) and the float32 validity weight.

The kernel is ``csrc/shuffle.cu``; :func:`swap_or_not_stream_plain`, built on
the bijection's plain version :func:`swap_or_not_plain`, runs for CPU
tensors and serves as the kernel's reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.hashing import as_u32, fmix32

SHUFFLE_ROUNDS = 64


def swap_or_not_plain(x, n: int, keys, salts):
    """The keyed bijection on every entry of ``x``: int [R, L]; keys: int32
    [K, 64] in [0, n); salts: int32 bit patterns [K, 64]; K is 1 (one
    permutation) or R (one per row)."""
    if n <= 1:
        return torch.zeros_like(x, dtype=torch.int32)
    v = x.to(torch.int64)
    k = keys.to(torch.int64)[:, None, :]       # [K, 1, ROUNDS] broadcasts over L
    s = as_u32(salts)[:, None, :]
    for r in range(SHUFFLE_ROUNDS):
        partner = k[..., r] - v
        partner = torch.where(partner < 0, partner + n, partner)
        m = fmix32(torch.maximum(v, partner) ^ s[..., r])
        v = torch.where((m & 1) == 1, partner, v)
    return v.to(torch.int32)


def swap_or_not_stream_plain(table, n: int, keys, salts, step_lo: int, n_steps: int,
                             dstep: int, per_cycle: int = 0):
    """The stream, plain: JAX's expressions on torch tensors of any
    device."""
    dev = keys.device
    s = step_lo + torch.arange(n_steps, device=dev)
    cols = torch.arange(dstep, device=dev)
    if per_cycle > 0:
        c = s // per_cycle
        slots = (s % per_cycle)[:, None] * dstep + cols[None, :]
        valid = slots < n
        x = torch.where(valid, slots, 0)
        keys, salts = keys[c], salts[c]                 # one permutation per cycle
    else:
        slots = s[:, None] * dstep + cols[None, :]
        valid = slots < n
        x = torch.where(valid, slots, 0) % max(n, 1)
    rows = swap_or_not_plain(x.to(torch.int32), n, keys, salts).long()
    cols = table[:, None] if table.dim() == 1 else table
    return tuple(cols[:, c][rows] for c in range(cols.shape[1])) + (valid.to(torch.float32),)


def swap_or_not(table, n: int, keys, salts, step_lo: int, n_steps: int, dstep: int,
                per_cycle: int = 0):
    """The epoch stream of steps ``[step_lo, step_lo + n_steps)``: each
    column of ``table`` (int32 [>= max(n, 1)] or [>= max(n, 1), 2]) at the
    slots' permuted rows, then the weights, each [n_steps, dstep] (int32,
    the weights float32), from the keys and salts (int32 [K, 64]: one row,
    or with ``per_cycle`` > 0 one per source cycle)."""
    if (table.dtype != torch.int32 or table.dim() not in (1, 2) or table.shape[0] < max(n, 1)
            or table.dim() == 2 and table.shape[1] not in (1, 2)):
        raise ValueError(f"swap_or_not takes an int32 [>= max(n, 1)] or [>= max(n, 1), 2] "
                         f"table: {table.dtype} {tuple(table.shape)}")
    if keys.dtype != torch.int32 or salts.dtype != torch.int32:
        raise TypeError("swap_or_not takes int32 keys and salt bit patterns")
    if keys.shape != salts.shape or keys.dim() != 2 or keys.shape[1] != SHUFFLE_ROUNDS:
        raise ValueError(f"keys/salts must be [K, {SHUFFLE_ROUNDS}]: {keys.shape}")
    if n_steps < 0 or dstep <= 0 or step_lo < 0 or per_cycle < 0:
        raise ValueError(f"swap_or_not: bad stream {step_lo}, {n_steps}, {dstep}, {per_cycle}")
    last_row = (step_lo + n_steps - 1) // per_cycle if per_cycle > 0 and n_steps else 0
    if last_row >= keys.shape[0]:
        raise ValueError(f"swap_or_not: cycle {last_row} has no key row of {keys.shape[0]}")
    if len({keys.device, salts.device, table.device}) != 1:
        raise ValueError("swap_or_not operands must share one device")
    if keys.device.type == "cpu":
        return swap_or_not_stream_plain(table, n, keys, salts, step_lo, n_steps, dstep,
                                        per_cycle)
    if keys.device.type != "cuda":
        raise ValueError(f"swap_or_not has no version for device {keys.device}")
    cols = 1 if table.dim() == 1 else table.shape[1]
    outs = [torch.empty((n_steps, dstep), dtype=torch.int32, device=keys.device)
            for _ in range(cols)]
    weight = torch.empty((n_steps, dstep), dtype=torch.float32, device=keys.device)
    table, keys, salts = table.contiguous(), keys.contiguous(), salts.contiguous()
    err = build.library("shuffle").swap_or_not(
        table.data_ptr(), cols, outs[0].data_ptr(), outs[-1].data_ptr() if cols == 2 else None,
        weight.data_ptr(), int(step_lo), int(n_steps), int(dstep), int(n), int(per_cycle),
        keys.data_ptr(), salts.data_ptr(), keys.shape[0], build.stream_handle(keys),
    )
    build.check(err, "swap_or_not")
    swap_or_not.launches += 1
    return (*outs, weight)


swap_or_not.launches = 0
