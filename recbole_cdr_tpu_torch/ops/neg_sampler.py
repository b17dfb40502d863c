"""K2: rejection-sampled uniform negatives against a padded history matrix.

Port of ``recbole_cdr_tpu/trainer/device_loop.py:205-325 _sample_negatives``
(uniform sampling over a candidate list of at most two contiguous id runs,
``_ranges_to_ids`` at :191). Slot t belongs to user ``uids[t % B]``; its
uint32 base bits are remixed into R = 16 candidate ranks by the murmur3
finalizer of ``base + r * 0x9E3779B9``, ranks map to item ids over the runs,
and the first round whose candidate is not in the user's history row wins
(round R-1 when none is clean). B2a, :func:`sample_negatives_popularity`,
is the popularity form (the alias branch, JAX :250-268): a second uint32
stream per slot, remixed the same way, accepts each round's column with its
alias probability or takes the column's alias, and the candidate is that
column's item id; the rejection is the same. The kernels are
``csrc/neg_sampler.cu``; the plain versions below run for CPU tensors and
serve as the kernels' reference. The heavy-user override stays with the
caller (``trainer/device_loop.py``).
"""

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.hashing import M32, as_u32, fmix32, mul32

R_ROUNDS = 16
_GOLDEN = 0x9E3779B9

#: compare elements per chunk of the plain version ([R, chunk, H] booleans)
_PLAIN_CHUNK_ELEMS = 1 << 27


def _runs(cand_ranges):
    """((s0, l0), (s1, l1)) of at most two candidate runs, as kernel scalars."""
    if not 1 <= len(cand_ranges) <= 2:
        raise ValueError(f"neg_sampler takes 1 or 2 candidate runs, got {cand_ranges}")
    (s0, l0), (s1, l1) = cand_ranges[0], (cand_ranges + ((0, 0),))[1]
    n_cand = l0 + l1
    if n_cand <= 0:
        raise ValueError("neg_sampler needs a non-empty candidate list")
    return s0, l0, s1, n_cand


def _remix(bits):
    """[R, total] uint32 values (int64) of each slot's R rounds: the murmur3
    finaliser of ``base + r * 0x9E3779B9``."""
    b = as_u32(bits)
    rounds = torch.arange(R_ROUNDS, device=bits.device, dtype=torch.int64)[:, None]
    return fmix32((b[None, :] + mul32(rounds, _GOLDEN)) & M32)


def _alias_candidates(base, accept, alias):
    """[R, total] popularity candidates: column ``x % n``, accepted when
    ``(y >> 8) * 2^-24 < prob[column]`` (float32) or its alias is < 0, else
    its alias; the candidate is ``values`` at the chosen column."""
    values, prob, alias_idx = alias
    ranks = _remix(base) % values.shape[0]
    u01 = (_remix(accept) >> 8).to(torch.float32) * 2.0 ** -24
    ali = alias_idx.long()[ranks]
    take = (u01 < prob[ranks]) | (ali < 0)
    return values.long()[torch.where(take, ranks, ali)]


def sample_negatives_plain(base, uids, hist, cand_ranges, neg_num: int, alias=None,
                           accept=None):
    """The kernels' arithmetic: uniform over ``cand_ranges``, or with
    ``alias`` (values, prob, alias) and its ``accept`` stream the popularity
    draw."""
    total = uids.shape[0] * neg_num
    if alias is not None:
        cand = _alias_candidates(base, accept, alias)
    else:
        s0, l0, s1, n_cand = _runs(cand_ranges)
        ranks = _remix(base) % n_cand                      # [R, total]
        cand = torch.where(ranks < l0, s0 + ranks, s1 + (ranks - l0))
    users = uids.to(torch.int64).repeat(neg_num)
    H = hist.shape[1]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (R_ROUNDS * max(H, 1)))
    coll = torch.zeros((R_ROUNDS, total), dtype=torch.bool, device=base.device)
    for lo in range(0, total, chunk):
        rows = hist[users[lo:lo + chunk]].to(torch.int64)  # [c, H]
        coll[:, lo:lo + chunk] = (rows[None] == cand[:, lo:lo + chunk, None]).any(-1)
    clean = ~coll
    first = clean.to(torch.int8).argmax(0)
    idx = torch.where(clean.any(0), first, R_ROUNDS - 1)
    return cand.gather(0, idx[None])[0].to(torch.int32)


def sample_negatives(base, uids, hist, cand_ranges, neg_num: int):
    """int32 [len(uids) * neg_num] negatives.

    base: int32 bit patterns of one uint32 per slot; uids: int32 [B];
    hist: int32 [num_users, H] padded history rows (padding never equals a
    candidate); cand_ranges: ((start, length), ...) with at most two runs."""
    total = uids.shape[0] * neg_num
    if base.dtype != torch.int32 or uids.dtype != torch.int32 or hist.dtype != torch.int32:
        raise TypeError("neg_sampler takes int32 base bits, uids and history")
    if base.shape != (total,) or uids.dim() != 1 or hist.dim() != 2:
        raise ValueError(f"neg_sampler shapes: base {base.shape}, uids {uids.shape}, hist {hist.shape}")
    if len({base.device, uids.device, hist.device}) != 1:
        raise ValueError("neg_sampler operands must share one device")
    if base.device.type == "cpu":
        return sample_negatives_plain(base, uids, hist, cand_ranges, neg_num)
    if base.device.type != "cuda":
        raise ValueError(f"neg_sampler has no version for device {base.device}")
    s0, l0, s1, n_cand = _runs(cand_ranges)
    base, uids, hist = base.contiguous(), uids.contiguous(), hist.contiguous()
    out = torch.empty(total, dtype=torch.int32, device=base.device)
    err = build.library("neg_sampler").neg_sampler(
        base.data_ptr(), uids.data_ptr(), max(uids.shape[0], 1), hist.data_ptr(),
        hist.shape[1], total, n_cand, s0, l0, s1, out.data_ptr(),
        build.stream_handle(base),
    )
    build.check(err, "neg_sampler")
    sample_negatives.launches += 1
    return out


sample_negatives.launches = 0


def _check_alias(alias, device):
    values, prob, alias_idx = alias
    if values.dtype != torch.int32 or prob.dtype != torch.float32 or alias_idx.dtype != torch.int32:
        raise TypeError("the alias table is int32 values, float32 prob, int32 alias")
    n = values.shape[0]
    if n == 0 or values.shape != (n,) or prob.shape != (n,) or alias_idx.shape != (n,):
        raise ValueError(f"the alias table's arrays must be [n] with n > 0: {values.shape}, "
                         f"{prob.shape}, {alias_idx.shape}")
    if any(t.device != device for t in alias):
        raise ValueError("neg_sampler_popularity operands must share one device")


def sample_negatives_popularity(base, accept, uids, hist, alias, neg_num: int):
    """B2a: int32 [len(uids) * neg_num] popularity negatives.

    base, accept: int32 bit patterns of one uint32 per slot each (the column
    and the acceptance streams); uids, hist as :func:`sample_negatives`;
    alias: (values int32 [n], prob float32 [n], alias int32 [n]) of the
    sampler's alias table."""
    total = uids.shape[0] * neg_num
    if (base.dtype != torch.int32 or accept.dtype != torch.int32 or uids.dtype != torch.int32
            or hist.dtype != torch.int32):
        raise TypeError("neg_sampler_popularity takes int32 bits, uids and history")
    if base.shape != (total,) or accept.shape != (total,) or uids.dim() != 1 or hist.dim() != 2:
        raise ValueError(f"neg_sampler_popularity shapes: base {base.shape}, accept "
                         f"{accept.shape}, uids {uids.shape}, hist {hist.shape}")
    if len({base.device, accept.device, uids.device, hist.device}) != 1:
        raise ValueError("neg_sampler_popularity operands must share one device")
    _check_alias(alias, base.device)
    if base.device.type == "cpu":
        return sample_negatives_plain(base, uids, hist, None, neg_num, alias, accept)
    if base.device.type != "cuda":
        raise ValueError(f"neg_sampler_popularity has no version for device {base.device}")
    values, prob, alias_idx = (t.contiguous() for t in alias)
    base, accept, uids, hist = (t.contiguous() for t in (base, accept, uids, hist))
    out = torch.empty(total, dtype=torch.int32, device=base.device)
    err = build.library("neg_sampler").neg_sampler_popularity(
        base.data_ptr(), accept.data_ptr(), uids.data_ptr(), max(uids.shape[0], 1),
        hist.data_ptr(), hist.shape[1], total, values.data_ptr(), prob.data_ptr(),
        alias_idx.data_ptr(), values.shape[0], out.data_ptr(), build.stream_handle(base),
    )
    build.check(err, "neg_sampler_popularity")
    sample_negatives_popularity.launches += 1
    return out


sample_negatives_popularity.launches = 0
