"""B10: the candidate top-k of candidate-ranking evaluation.

Port of ``recbole_cdr_tpu/evaluator/evaluator.py:88-93 _candidate_topk``:
over [B, C] scores of each user's sampled candidate list (eval mode
``uniform N`` / ``popularity N``), the slots ``cand_mask`` leaves out are
set to ``finfo(float32).min`` and the positions of the k best scores of each
row are taken, ties going to the lowest position, as ``lax.top_k`` does.
There is no history and no PAD column: column 0 is a row's first positive.
The kernel is the candidate form of ``csrc/masked_topk.cu`` (K4's selection
under a template flag, on K4's launch plan ``masked_topk_plan``); the plain
version below runs for CPU tensors and serves as the kernel's reference.
"""

import torch

from recbole_cdr_tpu_torch.ops import build
from recbole_cdr_tpu_torch.ops.masked_topk import (
    MAX_K,
    launch_plan_args,
    masked_topk_plan,
    sm_count,
)


def candidate_topk_plain(scores, cand_mask, k: int):
    s = torch.where(cand_mask, scores, torch.finfo(torch.float32).min)
    # a stable descending sort keeps equal scores in position order
    return torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k].to(torch.int32)


def candidate_topk(scores, cand_mask, k: int):
    """int32 [B, k] positions of the k best unmasked scores of each row.

    scores: float32 [B, C]; cand_mask: bool [B, C]; 1 <= k <= min(64, C)."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise TypeError("candidate_topk takes float32 [B, C] scores")
    if cand_mask.dtype != torch.bool or cand_mask.shape != scores.shape:
        raise TypeError("candidate_topk takes a bool mask of the scores' shape")
    B, C = scores.shape
    if not 1 <= k <= min(MAX_K, C):
        raise ValueError(f"candidate_topk takes 1 <= k <= min({MAX_K}, candidates), got k={k}")
    if scores.device != cand_mask.device:
        raise ValueError("candidate_topk operands must share one device")
    if scores.device.type == "cpu":
        return candidate_topk_plain(scores, cand_mask, k)
    if scores.device.type != "cuda":
        raise ValueError(f"candidate_topk has no version for device {scores.device}")
    scores, cand_mask = scores.contiguous(), cand_mask.contiguous()
    out = torch.empty((B, k), dtype=torch.int32, device=scores.device)
    plan = masked_topk_plan(B, C, k, sm_count(scores.device), cand=True)
    err = build.library("masked_topk").candidate_topk(
        scores.data_ptr(), B, C, cand_mask.data_ptr(), k, *launch_plan_args(plan),
        out.data_ptr(), build.stream_handle(scores),
    )
    build.check(err, "candidate_topk")
    candidate_topk.launches += 1
    return out


candidate_topk.launches = 0
