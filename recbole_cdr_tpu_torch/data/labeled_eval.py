"""Labeled evaluation batches (eval mode ``labeled``) — value-metric
evaluation over the split's (user, item, label) triples, the recbole 1.0.1
``EvaluatorType.VALUE`` path (metric registry at
`recbole_cdr/config/configurator.py:13` imports recbole's metric_types which
includes AUC/MAE/RMSE/LogLoss).

Static padded shapes: the last batch is padded and ``n_real`` marks the
valid prefix.

Port of ``recbole_cdr_tpu/data/labeled_eval.py`` (host numpy, unchanged).
"""

import numpy as np


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) == n:
        return arr
    out = np.zeros(n, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class LabeledEvalBatches:
    """Yields ``(user_ids[B], item_ids[B], labels[B], n_real)``."""

    is_labeled = True

    def __init__(self, table, eval_batch_size: int):
        self.users = table[table.uid_field].astype(np.int64)
        self.items = table[table.iid_field].astype(np.int64)
        if table.label_field not in table.arrays:
            raise ValueError(
                "labeled eval requires a label field: set `threshold` (e.g. "
                "{rating: 4}) or provide a label column in the .inter file"
            )
        self.labels = table[table.label_field].astype(np.float32)
        self.item_num = 0  # no full item axis in labeled mode
        self.batch = max(1, int(eval_batch_size))

    def __len__(self):
        return (len(self.users) + self.batch - 1) // self.batch

    def __iter__(self):
        B = self.batch
        for start in range(0, len(self.users), B):
            u = self.users[start:start + B]
            n_real = len(u)
            yield (
                _pad_to(u, B),
                _pad_to(self.items[start:start + B], B),
                _pad_to(self.labels[start:start + B], B),
                n_real,
            )
