"""Candidate-ranking evaluation batches (eval mode ``uniform N`` /
``popularity N``) — the analogue of recbole's ``NegSampleEvalDataLoader``
(routed by the reference at `recbole_cdr/data/utils.py:149-153`).

Port of ``recbole_cdr_tpu/data/candidate_eval.py`` (host numpy, unchanged):
the same sampler calls in the same order give the same candidate lists.

Each user's candidate list is their eval positives plus ``N`` sampled
negatives per positive; ranking metrics are computed within that list.
"""

import numpy as np


class CandidateEvalBatches:
    """Static-shape user batches with padded candidate lists.

    Yields ``(user_ids[B], cand_items[B, C], cand_mask[B, C], pos_mask[B, C],
    n_real)``; metric inputs derive from the ranking of each user's row.
    """

    is_candidate = True

    def __init__(self, table, sampler, neg_num: int, item_num: int,
                 eval_batch_size: int, seed: int = 0):
        uids = table[table.uid_field]
        iids = table[table.iid_field]
        self.item_num = item_num
        self.uid_field = table.uid_field

        order = np.argsort(uids, kind="stable")
        s_uids, s_iids = uids[order], iids[order]
        uniq, start_idx = np.unique(s_uids, return_index=True)
        self.uid_list = uniq.astype(np.int64)
        counts = np.diff(np.concatenate([start_idx, [len(s_uids)]]))
        self.pos_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.pos_items = s_iids.astype(np.int64)

        self.neg_num = neg_num
        max_pos = int(counts.max()) if len(counts) else 0
        self.max_cand = max_pos * (1 + neg_num)
        self.user_batch = max(1, eval_batch_size // max(self.max_cand, 1))

        # pre-sample negatives once (recbole samples at loader construction),
        # one vectorized sampler call for all users
        owners = np.repeat(self.uid_list, counts)
        flat = sampler.sample_by_user_ids(owners, neg_num)
        # layout: flat[i + j*len(owners)] is the j-th negative of row i
        per_row = flat.reshape(neg_num, len(owners)).T      # [n_pos_rows, neg]
        row_ptr = self.pos_ptr
        self._neg = [
            per_row[row_ptr[k]:row_ptr[k + 1]].reshape(-1)
            for k in range(len(self.uid_list))
        ]

    def __len__(self):
        return (len(self.uid_list) + self.user_batch - 1) // self.user_batch

    def __iter__(self):
        B, C = self.user_batch, max(self.max_cand, 1)
        for start in range(0, len(self.uid_list), B):
            uids = self.uid_list[start:start + B]
            n_real = len(uids)
            users = np.zeros(B, dtype=np.int64)
            users[:n_real] = uids
            cand = np.zeros((B, C), dtype=np.int64)
            cand_mask = np.zeros((B, C), dtype=bool)
            pos_mask = np.zeros((B, C), dtype=bool)
            for r, k in enumerate(range(start, start + n_real)):
                pos = self.pos_items[self.pos_ptr[k]:self.pos_ptr[k + 1]]
                negs = self._neg[k]
                row = np.concatenate([pos, negs])
                cand[r, : len(row)] = row
                cand_mask[r, : len(row)] = True
                pos_mask[r, : len(pos)] = True
            yield users, cand, cand_mask, pos_mask, n_real

    def positives_count(self, k: int) -> int:
        return int(self.pos_ptr[k + 1] - self.pos_ptr[k])
