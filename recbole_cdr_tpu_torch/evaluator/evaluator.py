"""Full-sort evaluation driver.

Port of ``recbole_cdr_tpu/evaluator/evaluator.py::FullSortEvaluator``. Two
device paths produce each eval user's top-k item ids; only those ids leave
the device, and hits and the recbole-exact metrics are computed on the host.

- Dense (item spaces below ``streaming_topk_threshold``, and every GAUC
  evaluation): per user tile, the scores (the model's full-sort form, a
  ``torch.matmul`` in full float32, or the trainer's predict fallback), then
  kernel K4 (``ops/masked_topk.py``) masks the tile's history and PAD column
  and selects the top-k; with GAUC, kernel B7 (``ops/rank_sum.py``) sums the
  ranks of each user's positives over the same masked row.
- Streaming (:meth:`FullSortEvaluator.evaluate_streaming`, models with
  dot-product factors): the factors are computed once per pass, then per
  user tile kernel B5 (``ops/topk.py``) scores the item axis in chunks and
  keeps each chunk's top-k, so no [B, items] score block exists. With
  ``eval_score_dtype: bfloat16`` the factors are cast to bf16 first (JAX
  ``evaluator.py:224-228,511-531,593-595``), and bf16 factors, which
  ``compute_dtype: bfloat16`` also yields, go to B13, the same top-k on
  bf16 products accumulated in float32.

Scores of a 16-bit ``compute_dtype`` (the dense path's full-sort form or
predict fallback, the candidate and labeled paths' predictions) reach K4,
B7, B10 and the host metrics through an exact ``.float()`` upcast: every
bf16 or float16 value is a float32 value, so ids, ranks and ties are those
of the 16-bit scores. The upcast is no fallback to float32 compute.

- Candidate ranking (:meth:`FullSortEvaluator.evaluate_candidates`, eval
  mode ``uniform N`` / ``popularity N``): per batch of users, the model's
  ``predict`` scores each user's sampled candidate list, kernel B10
  (``ops/candidate_topk.py``) takes the top-k positions and, with GAUC, B7's
  candidate form (``ops/rank_sum.py``) the positives' rank sums.

:class:`ValueEvaluator` computes the value metrics (AUC, MAE, RMSE, LogLoss)
of eval mode ``labeled`` from ``predict`` over the labeled triples.

Under a (data, model) mesh (``evaluate_streaming(mesh=...)``, JAX
``evaluator.py:561-610``) each streaming tile's users are split over
``data`` and the item columns over ``model``: kernel B14
(``ops/topk.py::sharded_streaming_topk``) takes each rank's top-k over its
rows of the item table and merges the model group's lists, then the [B/d,
k] ids are gathered over ``data``, so every rank computes the same host
metrics. The dense path under the mesh scores every user on every rank,
from the tables gathered over ``model`` (the model's full-sort form).
"""

import contextlib
from typing import Dict

import numpy as np
import torch

from recbole_cdr_tpu_torch.evaluator.metrics import (
    NON_ACCURACY_METRICS,
    compute_non_accuracy_metrics,
    compute_topk_metrics,
    compute_value_metrics,
    gauc_,
)
from recbole_cdr_tpu_torch.ops.candidate_topk import candidate_topk
from recbole_cdr_tpu_torch.ops.masked_topk import masked_topk
from recbole_cdr_tpu_torch.ops.rank_sum import rank_sum, rank_sum_candidates
from recbole_cdr_tpu_torch.ops.topk import sharded_streaming_topk, streaming_topk

#: ``eval_score_dtype`` values: the type the streaming path casts its score
#: factors to (JAX ``jnp.dtype(eval_score_dtype)``)
SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


@contextlib.contextmanager
def _float32_scores():
    """No TF32 in the scores' products: top-k ids and ranks must match the
    float32 reference."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _padded_positives(eval_batches, device):
    """Every eval user's positives padded to the widest user's count:
    int32 ids [U, P_pos] and a bool mask (``_fused_eval_arrays`` of the JAX
    package, `evaluator/evaluator.py:145-156`), cached per device."""
    key = ("pos", str(device))
    cache = getattr(eval_batches, "_fused_arrays", None)
    if cache is None:
        cache = eval_batches._fused_arrays = {}
    if key in cache:
        return cache[key]
    U = len(eval_batches.uid_list)
    lens = eval_batches.pos_lens
    P = max(int(lens.max()) if U else 0, 1)
    pos = np.zeros((U, P), np.int32)
    pmask = np.zeros((U, P), dtype=bool)
    pp = eval_batches.pos_ptr
    if pp[-1] > 0:
        owners = np.repeat(np.arange(U), lens)
        pos_in_row = np.arange(pp[-1]) - np.repeat(pp[:-1], lens)
        pos[owners, pos_in_row] = eval_batches.pos_items
        pmask[owners, pos_in_row] = True
    cache[key] = (torch.as_tensor(pos, device=device), torch.as_tensor(pmask, device=device))
    return cache[key]


def _fused_eval_arrays(eval_batches, B: int, device):
    """Device-resident eval operands, built once per (eval split, tile
    width, device): uids [U] and the history of each user tile of B rows in
    CSR form — ``row_ptr`` [n_tiles, B + 1] and ``items`` [n_tiles, P], where
    P is the heaviest tile's pair count (tail-robust: a padded [U, max_hist]
    matrix would scale with the heaviest user's degree)."""
    key = (B, str(device))
    cache = getattr(eval_batches, "_fused_arrays", None)
    if cache is None:
        cache = eval_batches._fused_arrays = {}
    if key in cache:
        return cache[key]
    U = len(eval_batches.uid_list)
    n_tiles = max(-(-U // B), 1)
    hp = eval_batches.hist_ptr
    bounds = np.minimum(np.arange(n_tiles + 1) * B, U)
    tile_starts = hp[bounds[:-1]]
    P = max(int((hp[bounds[1:]] - tile_starts).max()), 1)
    row_ptr = np.zeros((n_tiles, B + 1), np.int32)
    rows = np.minimum(np.arange(n_tiles)[:, None] * B + np.arange(B + 1)[None, :], U)
    row_ptr[:] = hp[rows] - tile_starts[:, None]
    items = np.zeros((n_tiles, P), np.int32)
    if hp[-1] > 0:
        owners = np.repeat(np.arange(U), np.diff(hp))
        pair_tile = owners // B
        items[pair_tile, np.arange(hp[-1]) - tile_starts[pair_tile]] = eval_batches.hist_items
    arrs = (
        torch.as_tensor(np.asarray(eval_batches.uid_list, np.int64), device=device),
        torch.as_tensor(row_ptr, device=device),
        torch.as_tensor(items, device=device),
    )
    cache[key] = arrs
    return arrs


class FullSortEvaluator:
    """Evaluate a model's full-sort ranking quality over eval batches."""

    #: per-dispatch budget of score-matrix elements: the tiles of one segment
    #: are scored before their ids are copied to the host together
    DENSE_SEG_ELEMS = 1 << 29

    #: minimum user rows per dense tile (results are row-independent, so
    #: re-blocking cannot change metrics)
    DENSE_USER_BLOCK = 2048

    #: per-segment element budget of pair-cost scorers (the predict
    #: fallback: each score is a prediction, not a dot product); their tiles
    #: keep ``user_batch`` rows
    HEAVY_SEG_ELEMS = 1 << 23

    def __init__(self, config):
        self.metrics = [m.lower() for m in config["metrics"]]
        self.non_acc_metrics = [m for m in self.metrics if m in NON_ACCURACY_METRICS]
        self.topk_metrics = [
            m for m in self.metrics
            if m != "gauc" and m not in NON_ACCURACY_METRICS
        ]
        self.need_gauc = "gauc" in self.metrics
        # eval_score_dtype: the streaming path casts its score factors to it
        # (half the item table's bytes in bf16); accumulation and top-k stay
        # float32. The dense path ignores it, as in JAX.
        sd = config["eval_score_dtype"]
        if sd is not None and str(sd).lower() not in SCORE_DTYPES:
            raise ValueError(f"eval_score_dtype must be one of {sorted(SCORE_DTYPES)}, "
                             f"got {sd!r}")
        self.score_dtype = SCORE_DTYPES[str(sd).lower()] if sd is not None else None
        self.need_rec_items = bool(self.non_acc_metrics)
        self.tail_ratio = config["tail_ratio"] or 0.1
        self.topk = config["topk"]
        self.max_k = max(self.topk)
        self.decimal_place = config["metric_decimal_place"] or 4

    #: minimum user rows per streaming tile (the JAX package's
    #: STREAM_USER_BLOCK); streaming memory is O(B * k * item chunks), not
    #: O(B * items)
    STREAM_USER_BLOCK = 2048

    def _empty_result(self) -> Dict[str, float]:
        out = {f"{m}@{k}": 0.0 for m in self.topk_metrics for k in self.topk}
        out.update({f"{m}@{k}": 0.0 for m in self.non_acc_metrics for k in self.topk})
        if self.need_gauc:
            out["gauc"] = 0.0
        return out

    def _add_non_accuracy(self, result, rec_items, eval_batches, item_num):
        """Append ItemCoverage/AveragePopularity/GiniIndex/ShannonEntropy/
        TailPercentage computed from the recommended item-id matrix."""
        if not self.need_rec_items:
            return result
        counts = getattr(eval_batches, "train_item_counts", None)
        if counts is None:
            if {"averagepopularity", "tailpercentage"} & set(self.non_acc_metrics):
                raise ValueError(
                    "AveragePopularity/TailPercentage need train item counts "
                    "(eval_batches.train_item_counts missing)"
                )
            counts = np.zeros(item_num, np.int64)
        result.update(
            compute_non_accuracy_metrics(
                rec_items, counts, item_num, self.non_acc_metrics,
                self.topk, self.tail_ratio,
            )
        )
        return result

    @staticmethod
    def _segmentation(eval_batches, elems_budget, B=None):
        """(seg_tiles, n_segments): tiles per segment bounded by
        ``elems_budget`` score elements."""
        U = len(eval_batches.uid_list)
        if B is None:
            B = eval_batches.user_batch
        n_tiles = -(-U // B)
        seg = max(1, min(n_tiles, elems_budget // max(B * eval_batches.item_num, 1)))
        return seg, -(-n_tiles // seg)

    def _dense_budget(self, eval_batches, score_fn=None):
        """(user-block rows, per-segment element budget) for the dense path,
        by the scorer's cost class."""
        if getattr(score_fn, "_pair_cost", False):
            return eval_batches.user_batch, self.HEAVY_SEG_ELEMS
        U = len(eval_batches.uid_list)
        cap = max(self.DENSE_SEG_ELEMS // max(eval_batches.item_num, 1), 1)
        B = max(eval_batches.user_batch, min(self.DENSE_USER_BLOCK, U, cap))
        return B, self.DENSE_SEG_ELEMS

    def topk_ids(self, score_fn, eval_batches, device, with_rank_sums=False):
        """[U, max_k] top-k item ids of every eval user (host array); with
        ``with_rank_sums``, also the [U] GAUC rank sums (None without GAUC).
        ``score_fn(users [B] int64) -> scores [B, item_num]`` on ``device``."""
        U = len(eval_batches.uid_list)
        B, budget = self._dense_budget(eval_batches, score_fn)
        seg, n_segs = self._segmentation(eval_batches, budget, B)
        uids, row_ptr, items = _fused_eval_arrays(eval_batches, B, device)
        if self.need_gauc:
            pos, pmask = _padded_positives(eval_batches, device)
        n_tiles = -(-U // B)
        out, sums = [], []
        with _float32_scores():
            for s in range(n_segs):
                ids, rs = [], []
                for t in range(s * seg, min((s + 1) * seg, n_tiles)):
                    users = uids[t * B:(t + 1) * B]
                    scores = score_fn(users).float()  # exact for 16-bit scores
                    n = users.shape[0]
                    rp = row_ptr[t, :n + 1]
                    ids.append(masked_topk(scores, rp, items[t], self.max_k))
                    if self.need_gauc:
                        rows = slice(t * B, t * B + n)
                        rs.append(rank_sum(scores, rp, items[t], pos[rows], pmask[rows]))
                out.append(torch.cat(ids).cpu().numpy())
                if rs:
                    sums.append(torch.cat(rs).cpu().numpy())
        ids = np.concatenate(out).astype(np.int64)
        if not with_rank_sums:
            return ids
        return ids, np.concatenate(sums) if self.need_gauc else None

    def streaming_topk_ids(self, factors_fn, eval_batches, device, mesh=None) -> np.ndarray:
        """[U, max_k] top-k item ids of every eval user (host array) through
        kernel B5 (float32 factors) or B13 (bfloat16 or float16 factors).
        ``factors_fn(users [U] int64) -> (user_e [U, D], item_table
        [item_num, D])`` on ``device``, called once per pass; the factors
        are cast to ``eval_score_dtype`` when it is set. Under ``mesh`` the
        factors are ``(user_e, this rank's rows of the item table, their
        first global item)`` and every tile runs B14."""
        U = len(eval_batches.uid_list)
        B = max(eval_batches.user_batch, min(self.STREAM_USER_BLOCK, U))
        uids, row_ptr, items = _fused_eval_arrays(eval_batches, B, device)
        with torch.no_grad():
            user_e, item_table, *offset = factors_fn(uids)
            if self.score_dtype is not None:
                user_e = user_e.to(self.score_dtype)
                item_table = item_table.to(self.score_dtype)
            ids = []
            for t in range(-(-U // B)):
                block = user_e[t * B:(t + 1) * B]
                n = block.shape[0]
                if mesh is None:
                    ids.append(streaming_topk(block, item_table, row_ptr[t, :n + 1], items[t],
                                              self.max_k)[1])
                else:
                    ids.append(self._sharded_tile(block, item_table, offset[0],
                                                  row_ptr[t, :n + 1], items[t],
                                                  eval_batches.item_num, mesh))
            return torch.cat(ids).cpu().numpy().astype(np.int64)

    def _sharded_tile(self, users, block, col_offset, row_ptr, items, item_num, mesh):
        """One streaming tile over the mesh: this rank's ``data`` slice of the
        tile's users (ceil(n / d) rows, the last slice padded with zero rows
        and empty histories), B14 over the model group, then the slices' ids
        gathered over ``data``: [n, k] on every rank."""
        n = users.shape[0]
        per = -(-n // mesh.data)
        lo = min(mesh.data_index * per, n)
        hi = min(lo + per, n)
        local = users.new_zeros((per, users.shape[1]))
        local[:hi - lo] = users[lo:hi]
        rp = row_ptr[torch.clamp(torch.arange(lo, lo + per + 1, device=row_ptr.device), max=hi)]
        _, ids = sharded_streaming_topk(local, block, rp, items, self.max_k, col_offset,
                                        item_num, mesh.model_group)
        return mesh.gather_data(ids)[:n]

    def evaluate_streaming(self, factors_fn, eval_batches, device,
                           mesh=None) -> Dict[str, float]:
        """Full-sort evaluation via the streaming top-k: the [B, items] score
        matrix never exists. GAUC needs full rank statistics, so callers
        route it to :meth:`evaluate`. With ``mesh``, the users of each tile
        are split over 'data' and the items over 'model' (B14)."""
        if self.need_gauc:
            raise ValueError("GAUC requires dense full-sort evaluation, not streaming.")
        if len(eval_batches.uid_list) == 0:
            return self._empty_result()
        return self._result(self.streaming_topk_ids(factors_fn, eval_batches, device, mesh),
                            eval_batches)

    def evaluate(self, score_fn, eval_batches, device) -> Dict[str, float]:
        """Returns {metric@k: value} averaged over the eval users, plus
        ``gauc`` when asked for (from the full-row rank sums)."""
        if len(eval_batches.uid_list) == 0:
            return self._empty_result()
        ids, rank_sums = self.topk_ids(score_fn, eval_batches, device, with_rank_sums=True)
        return self._result(ids, eval_batches, rank_sums)

    def _result(self, topk_idx, eval_batches, rank_sums=None) -> Dict[str, float]:
        """Hits of the [U, max_k] top-k ids against the positives, then the
        metrics; GAUC from the rank sums over rows of ``item_num`` items."""
        U = len(eval_batches.uid_list)
        item_num = eval_batches.item_num
        pos_keys = eval_batches.pos_keys_sorted
        owners = np.arange(U, dtype=np.int64)[:, None]
        q = owners * item_num + topk_idx
        loc = np.searchsorted(pos_keys, q)
        loc = np.minimum(loc, max(len(pos_keys) - 1, 0))
        pos_index = pos_keys[loc] == q if len(pos_keys) else np.zeros_like(q, bool)
        pos_len = eval_batches.pos_lens.astype(np.int64)
        result = compute_topk_metrics(pos_index, pos_len, self.topk_metrics, self.topk)
        if rank_sums is not None:
            result["gauc"] = gauc_(np.full(U, item_num, np.int64), pos_len, rank_sums)
        result = self._add_non_accuracy(result, topk_idx, eval_batches, item_num)
        return {k: round(v, self.decimal_place) for k, v in result.items()}

    def evaluate_candidates(self, predict_fn, eval_batches, device, uid_key: str,
                            iid_key: str) -> Dict[str, float]:
        """Candidate-ranking evaluation (eval mode ``uniform N``): rank each
        user's positives among their sampled candidate list (JAX
        ``evaluate_candidates``, `evaluator.py:625-696`). ``predict_fn(batch)
        -> scores`` scores a dict of target user and item ids."""
        all_pos_index, all_pos_len = [], []
        all_rank_sum, all_user_len = [], []
        all_rec_items = []
        with _float32_scores():
            for users, cand, cand_mask, pos_mask, n_real in eval_batches:
                C = cand.shape[1]
                u = torch.as_tensor(users, device=device)
                c = torch.as_tensor(cand, device=device)
                cm = torch.as_tensor(cand_mask, device=device)
                scores = predict_fn({uid_key: u.repeat_interleave(C),
                                     iid_key: c.reshape(-1)}).reshape(cand.shape).float()
                k_eff = min(self.max_k, C)
                topk_idx = candidate_topk(scores, cm, k_eff).cpu().numpy().astype(np.int64)
                if self.need_rec_items:
                    # positions -> item ids; ranks beyond the candidate count
                    # pad with PAD id 0
                    all_rec_items.append(self._pad_to_max_k(
                        np.take_along_axis(cand[:n_real], topk_idx[:n_real], axis=1)))
                if self.need_gauc:
                    # ranks among each row's candidates, padded slots at -inf
                    pm = torch.as_tensor(pos_mask, device=device)
                    rs = rank_sum_candidates(scores, cm, pm).cpu().numpy()
                    all_rank_sum.extend(rs[:n_real])
                    all_user_len.extend(cand_mask[:n_real].sum(axis=1))
                all_pos_index.append(self._pad_to_max_k(
                    np.take_along_axis(pos_mask[:n_real], topk_idx[:n_real], axis=1)))
                all_pos_len.append(pos_mask[:n_real].sum(axis=1))

        if not all_pos_index:
            return self._empty_result()
        pos_index = np.concatenate(all_pos_index, axis=0)
        pos_len = np.concatenate(all_pos_len).astype(np.int64)
        result = compute_topk_metrics(pos_index, pos_len, self.topk_metrics, self.topk)
        if self.need_gauc:
            result["gauc"] = gauc_(np.array(all_user_len, np.int64), pos_len,
                                   np.array(all_rank_sum))
        rec_items = np.concatenate(all_rec_items) if all_rec_items else None
        result = self._add_non_accuracy(result, rec_items, eval_batches, eval_batches.item_num)
        return {k: round(v, self.decimal_place) for k, v in result.items()}

    def _pad_to_max_k(self, a):
        """``a`` [n, k_eff] widened to [n, max_k] with zeros (PAD ids, no
        hits) where a list has fewer candidates than ``max_k``."""
        return np.pad(a, ((0, 0), (0, self.max_k - a.shape[1])))


class ValueEvaluator:
    """Value-metric evaluation over labeled (user, item, label) triples —
    the recbole 1.0.1 ``eval_args mode: labeled`` path (AUC / MAE / RMSE /
    LogLoss, pooled over the whole eval split). Port of the JAX package's
    ``ValueEvaluator`` (`evaluator.py:699-726`)."""

    def __init__(self, config):
        self.metrics = [m.lower() for m in config["metrics"]]
        self.decimal_place = config["metric_decimal_place"] or 4

    def evaluate(self, predict_fn, eval_batches, device, uid_key: str,
                 iid_key: str) -> Dict[str, float]:
        preds, trues = [], []
        with _float32_scores():
            for users, items, labels, n_real in eval_batches:
                out = predict_fn({uid_key: torch.as_tensor(users, device=device),
                                  iid_key: torch.as_tensor(items, device=device)})
                preds.append(out.float().cpu().numpy()[:n_real])
                trues.append(labels[:n_real])
        if not preds:
            return {m: 0.0 for m in self.metrics}
        result = compute_value_metrics(np.concatenate(trues), np.concatenate(preds), self.metrics)
        return {k: round(v, self.decimal_place) for k, v in result.items()}
