"""B12: DCDCSR's benchmark top-k and blend.

Port of the non-overlapped part of ``recbole_cdr_tpu/models/dcdcsr.py:179-189
DCDCSR._build_benchmark``: for each row of ``rest`` [M, D] (the target
table's rows past the overlap), the similarities to the ``n_ov`` overlapped
source rows, their top k (largest first, the lower index first on a tie, as
``lax.top_k``), and the blend of the row with the similarity-weighted mean
of those k source rows, weighted by the popularity ratio ``beta = sn / (sn +
t_pop)`` (``sn`` the mean source popularity of the k rows; NaN where both
are 0, as in JAX). The kernel is ``csrc/benchmark_topk.cu``; the plain
version below runs for CPU tensors and serves as the kernel's reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build

#: the largest k the kernel takes (its register lists hold 16 or 32 entries)
MAX_K = 32
#: the most column ranges the kernel splits the similarities into
MAX_SPLITS = 8


def benchmark_topk_plain(rest, src, s_pop, t_pop, k: int):
    """(out [M, D], idx int32 [M, k], sim [M, k]) by torch.matmul and a stable
    descending sort (equal similarities keep the lower index first: most
    rows of a table whose rows are zero have every similarity exactly 0)."""
    sims = rest @ src.T
    order = torch.sort(sims, dim=1, descending=True, stable=True)
    sim, idx = order.values[:, :k], order.indices[:, :k]
    sn = s_pop[idx].mean(1)
    beta = sn / (sn + t_pop)
    sim_e = torch.einsum("mk,mkd->md", sim, src[idx])
    sum_sim = sim.sum(1)
    sum_sim = torch.where(sum_sim > 0, sum_sim, torch.ones_like(sum_sim))
    out = (1 - beta)[:, None] * rest + beta[:, None] * (sim_e / sum_sim[:, None])
    return out, idx.to(torch.int32), sim


def benchmark_topk(rest, src, s_pop, t_pop, k: int):
    """The benchmark rows of ``rest`` [M, D] against the overlapped source
    rows ``src`` [n_ov, D]: (out [M, D], idx int32 [M, k], sim [M, k]).

    s_pop: float32 [n_ov], the source popularity of each overlapped row;
    t_pop: float32 [M], the target popularity of each row of ``rest``;
    1 <= k <= min(32, n_ov)."""
    tensors = (rest, src, s_pop, t_pop)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("benchmark_topk takes float32 tables and popularities")
    if rest.dim() != 2 or src.dim() != 2 or rest.shape[1] != src.shape[1]:
        raise ValueError(f"benchmark_topk tables must be [M, D] and [n_ov, D]: "
                         f"{tuple(rest.shape)}, {tuple(src.shape)}")
    M, D = rest.shape
    n_ov = src.shape[0]
    if s_pop.shape != (n_ov,) or t_pop.shape != (M,):
        raise ValueError(f"benchmark_topk takes s_pop [{n_ov}] and t_pop [{M}]: "
                         f"{tuple(s_pop.shape)}, {tuple(t_pop.shape)}")
    if not 1 <= k <= min(MAX_K, n_ov):
        raise ValueError(f"benchmark_topk takes 1 <= k <= min({MAX_K}, overlapped rows "
                         f"{n_ov}), got k={k}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("benchmark_topk operands must share one device")
    dev = rest.device
    if dev.type == "cpu":
        return benchmark_topk_plain(rest, src, s_pop, t_pop, k)
    if dev.type != "cuda":
        raise ValueError(f"benchmark_topk has no version for device {dev}")
    rest, src, s_pop, t_pop = (t.contiguous() for t in tensors)
    # column ranges enough for ~4 blocks of 64 rows per SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(MAX_SPLITS, n_ov, -(-4 * sms // max(1, -(-M // 64)))))
    width = 16 if k <= 16 else 32
    part_val = torch.empty((splits, M, width), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, M, width), dtype=torch.int32, device=dev)
    out = torch.empty((M, D), dtype=torch.float32, device=dev)
    idx = torch.empty((M, k), dtype=torch.int32, device=dev)
    sim = torch.empty((M, k), dtype=torch.float32, device=dev)
    err = build.library("benchmark_topk").benchmark_topk(
        rest.data_ptr(), src.data_ptr(), s_pop.data_ptr(), t_pop.data_ptr(), M, n_ov, D, k,
        splits, part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(), idx.data_ptr(),
        sim.data_ptr(), build.stream_handle(rest),
    )
    build.check(err, "benchmark_topk")
    benchmark_topk.launches += 1
    return out, idx, sim


benchmark_topk.launches = 0
