"""Cross-domain dataset core: load -> filter -> link -> sectioned remap -> split.

Standalone re-implementation of the observable dataset semantics of the
reference (`recbole_cdr/data/dataset.py:28-707` plus inherited recbole 1.0.1
``Dataset`` load/filter/split behavior), built host-side on numpy/pandas and
handing static numpy arrays to the device pipeline. Of the JAX package's
interaction-matrix helpers, the sparse matrix (BiTGCF's graph) is ported;
the padded history matrices come with the history models (ROADMAP.md A8).

The load-bearing invariant — the unified sectioned ID space
(`recbole_cdr/data/dataset.py:344-445`):

    index 0                            : [PAD]
    1 .. n_overlap-1                   : overlapped entities (sorted by raw token)
    n_overlap .. n_overlap+n_target-1  : target-only entities (sorted)
    then .. n_total-1                  : source-only entities (sorted)

Target-domain IDs therefore form the contiguous prefix
``[0, num_overlap + num_target_only)`` and ``table[:target_num_items]`` slices
"all target items" in every full-sort scorer.
"""


import os
import re
from logging import getLogger
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
from scipy.sparse import coo_matrix

from recbole_cdr_tpu_torch.data.atomic import find_atomic_files, load_atomic_file, load_link_file
from recbole_cdr_tpu_torch.utils.enums import FeatureType

_INTERVAL_RE = re.compile(r"\s*([\[\(])\s*([^,]+)\s*,\s*([^\]\)]+)\s*([\]\)])\s*")


def parse_interval(s: str):
    """Parse an interval string like ``"[5,inf)"`` into
    (low, high, low_inclusive, high_inclusive)."""
    m = _INTERVAL_RE.fullmatch(s)
    if not m:
        raise ValueError(f"Unrecognized interval string [{s}]")
    lo = float(m.group(2))
    hi = float(m.group(3))
    return lo, hi, m.group(1) == "[", m.group(4) == "]"


def interval_mask(values: np.ndarray, s: str) -> np.ndarray:
    lo, hi, lo_inc, hi_inc = parse_interval(s)
    v = values.astype(np.float64)
    lo_ok = v >= lo if lo_inc else v > lo
    hi_ok = v <= hi if hi_inc else v < hi
    return lo_ok & hi_ok


def calcu_split_ids(tot: int, ratios: List[float]) -> List[int]:
    """Per-group split boundary computation, bit-equal to recbole 1.0.1
    ``Dataset._calcu_split_ids``."""
    cnt = [int(ratios[i] * tot) for i in range(len(ratios))]
    cnt[0] = tot - sum(cnt[1:])
    for i in range(1, len(ratios)):
        if cnt[0] <= 1:
            break
        if 0 < ratios[-i] * tot < 1:
            cnt[-i] += 1
            cnt[0] -= 1
    return list(np.cumsum(cnt)[:-1])


class DomainDataset:
    """One domain's dataset: atomic-file load + filtering, with the joint
    remap deferred to :class:`CrossDomainDataset`.

    Mirrors ``CrossDomainSingleDataset`` (`recbole_cdr/data/dataset.py:28-290`).
    """

    def __init__(self, config, domain: str):
        self.config = config
        self.domain = domain
        self.logger = getLogger()

        self.dataset_name = config["dataset"]
        self.dataset_path = config["data_path"]
        self.field_separator = config["field_separator"] or "\t"
        self.encoding = config["encoding"] or "utf-8"

        self.uid_field = config["USER_ID_FIELD"]
        self.iid_field = config["ITEM_ID_FIELD"]
        self.rating_field = config["RATING_FIELD"]
        self.time_field = config["TIME_FIELD"]
        self.label_field = config["LABEL_FIELD"]
        self.neg_prefix = config["NEG_PREFIX"]

        self.field2type: Dict[str, FeatureType] = {}
        self.field2source: Dict[str, str] = {}
        self.field2token_id: Dict[str, dict] = {}
        self.field2id_token: Dict[str, list] = {}

        self.inter_feat: Optional[pd.DataFrame] = None
        self.user_feat: Optional[pd.DataFrame] = None
        self.item_feat: Optional[pd.DataFrame] = None

        self._load()
        self._filter()
        # int-array views populated by finalize()
        self.arrays: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------- load

    def _load(self):
        files = find_atomic_files(self.dataset_path, self.dataset_name)
        if "inter" not in files:
            raise ValueError(
                f"File {os.path.join(self.dataset_path, self.dataset_name + '.inter')} not exist."
            )
        load_col = self.config["load_col"] or {}
        for suffix, path in files.items():
            usecols = load_col.get(suffix) if load_col else None
            if load_col and suffix not in load_col:
                if suffix != "inter":
                    continue
            df, ftypes = load_atomic_file(
                path, self.field_separator, self.encoding, usecols=usecols,
                seq_separator=self.config["seq_separator"] or " ",
            )
            for f, t in ftypes.items():
                self.field2type[f] = t
                self.field2source[f] = suffix
            if suffix == "inter":
                self.inter_feat = df
            elif suffix == "user":
                self.user_feat = df
            elif suffix == "item":
                self.item_feat = df
        if self.uid_field not in self.inter_feat.columns:
            raise ValueError(f"user id field [{self.uid_field}] not in inter file.")
        if self.iid_field not in self.inter_feat.columns:
            raise ValueError(f"item id field [{self.iid_field}] not in inter file.")

    # ----------------------------------------------------------------- filter

    def _filter(self):
        self._filter_nan_user_or_item()
        self._remove_duplication()
        self._filter_by_field_value()
        self._filter_by_inter_num()
        self.inter_feat = self.inter_feat.reset_index(drop=True)

    def _remove_duplication(self):
        """``rm_dup_inter``: keep the first/last interaction per (user, item)
        pair, ordered by time when a time column exists (recbole semantics)."""
        keep = self.config["rm_dup_inter"]
        if keep is None:
            return
        if keep not in ("first", "last"):
            raise ValueError(f"rm_dup_inter [{keep}] should be 'first' or 'last'.")
        if self.time_field and self.time_field in self.inter_feat.columns:
            self.inter_feat = self.inter_feat.sort_values(by=self.time_field, kind="stable")
        self.inter_feat = self.inter_feat.drop_duplicates(
            subset=[self.uid_field, self.iid_field], keep=keep
        )

    def _filter_nan_user_or_item(self):
        for field, feat in ((self.uid_field, self.user_feat), (self.iid_field, self.item_feat)):
            if field in self.inter_feat.columns:
                self.inter_feat = self.inter_feat.dropna(subset=[field])
            if feat is not None and field in feat.columns:
                feat.dropna(subset=[field], inplace=True)

    def _filter_by_field_value(self):
        val_interval = self.config["val_interval"]
        if not val_interval:
            return
        drop_fields = []
        for field, interval in val_interval.items():
            if field in self.inter_feat.columns:
                mask = interval_mask(self.inter_feat[field].to_numpy(), interval)
                self.inter_feat = self.inter_feat[mask]
            if self.user_feat is not None and field in self.user_feat.columns:
                self.user_feat = self.user_feat[
                    interval_mask(self.user_feat[field].to_numpy(), interval)
                ]
            if self.item_feat is not None and field in self.item_feat.columns:
                self.item_feat = self.item_feat[
                    interval_mask(self.item_feat[field].to_numpy(), interval)
                ]
            drop_fields.append(field)
        if self.config["drop_filter_field"]:
            for field in drop_fields:
                for feat_name in ("inter_feat", "user_feat", "item_feat"):
                    feat = getattr(self, feat_name)
                    if feat is not None and field in feat.columns:
                        setattr(self, feat_name, feat.drop(columns=[field]))
                self.field2type.pop(field, None)
                self.field2source.pop(field, None)

    def _filter_by_inter_num(self):
        """Iteratively drop users/items whose interaction count falls outside
        the configured intervals, until stable (recbole 1.0.1 semantics)."""
        user_interval = self.config["user_inter_num_interval"]
        item_interval = self.config["item_inter_num_interval"]
        if not user_interval and not item_interval:
            return
        while True:
            changed = False
            if user_interval:
                counts = self.inter_feat[self.uid_field].value_counts()
                ok = counts[interval_mask(counts.to_numpy(), user_interval)].index
                mask = self.inter_feat[self.uid_field].isin(ok)
                if not mask.all():
                    self.inter_feat = self.inter_feat[mask]
                    changed = True
            if item_interval:
                counts = self.inter_feat[self.iid_field].value_counts()
                ok = counts[interval_mask(counts.to_numpy(), item_interval)].index
                mask = self.inter_feat[self.iid_field].isin(ok)
                if not mask.all():
                    self.inter_feat = self.inter_feat[mask]
                    changed = True
            if not changed:
                break
        # drop user/item feat rows for banned entities
        if self.user_feat is not None:
            self.user_feat = self.user_feat[
                self.user_feat[self.uid_field].isin(set(self.inter_feat[self.uid_field]))
            ]
        if self.item_feat is not None:
            self.item_feat = self.item_feat[
                self.item_feat[self.iid_field].isin(set(self.inter_feat[self.iid_field]))
            ]

    # ------------------------------------------------------------------ remap

    def token_sets(self):
        """Raw-token sets of users and items present in this domain
        (inter + user/item feat), for the joint remap."""
        users = set(self.inter_feat[self.uid_field])
        if self.user_feat is not None:
            users |= set(self.user_feat[self.uid_field])
        items = set(self.inter_feat[self.iid_field])
        if self.item_feat is not None:
            items |= set(self.item_feat[self.iid_field])
        users.discard(np.nan)
        items.discard(np.nan)
        return users, items

    def apply_token_link(self, user_link: Optional[dict], item_link: Optional[dict]):
        """Translate source tokens into target tokens via the link dicts
        (reference `recbole_cdr/data/dataset.py:320-323`)."""
        for field, link in ((self.uid_field, user_link), (self.iid_field, item_link)):
            if not link:
                continue
            for feat in (self.inter_feat, self.user_feat, self.item_feat):
                if feat is not None and field in feat.columns:
                    feat[field] = feat[field].map(lambda x: link.get(x, x))

    def remap_to_ids(self, uid_map: dict, iid_map: dict, uid_tokens: list, iid_tokens: list):
        """Replace raw tokens by unified integer IDs."""
        self.field2token_id[self.uid_field] = uid_map
        self.field2token_id[self.iid_field] = iid_map
        self.field2id_token[self.uid_field] = uid_tokens
        self.field2id_token[self.iid_field] = iid_tokens
        for field, mapping in ((self.uid_field, uid_map), (self.iid_field, iid_map)):
            for feat in (self.inter_feat, self.user_feat, self.item_feat):
                if feat is not None and field in feat.columns:
                    feat[field] = feat[field].map(mapping).astype(np.int64)

    def remap_other_tokens(self):
        """Factorize the remaining token / token_seq fields (recbole
        ``_remap_ID_all`` / reference ``remap_others_id``,
        `recbole_cdr/data/dataset.py:102-107`): every non-id token field gets
        its own ``field2token_id`` / ``field2id_token`` mapping ('[PAD]' at
        id 0, tokens in first-appearance order — pd.factorize semantics) and
        its columns become integer ids (token_seq cells become int arrays)."""
        feats = [f for f in (self.inter_feat, self.user_feat, self.item_feat)
                 if f is not None]
        for field, ftype in self.field2type.items():
            if field in (self.uid_field, self.iid_field):
                continue
            if ftype not in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ):
                continue
            cols = [f for f in feats if field in f.columns]
            if not cols:
                continue
            if ftype == FeatureType.TOKEN:
                flat = np.concatenate([f[field].astype(str).to_numpy() for f in cols])
            else:
                flat = np.concatenate(
                    [np.concatenate([np.asarray(v, dtype=object) for v in f[field]])
                     if len(f) else np.array([], dtype=object) for f in cols]
                ) if any(len(f) for f in cols) else np.array([], dtype=object)
            codes, uniques = pd.factorize(flat)
            token_id = {tok: i + 1 for i, tok in enumerate(uniques)}
            self.field2token_id[field] = token_id
            self.field2id_token[field] = ["[PAD]"] + list(uniques)
            for f in cols:
                if ftype == FeatureType.TOKEN:
                    f[field] = f[field].astype(str).map(token_id).astype(np.int64)
                else:
                    f[field] = [
                        np.asarray([token_id[t] for t in v], dtype=np.int64)
                        for v in f[field]
                    ]

    def finalize(self):
        """Post-remap processing: label threshold, column prefixing, and the
        numpy array views consumed by the batch pipeline
        (mirrors ``data_process_after_remap``, reference `dataset.py:125-136`)."""
        self.remap_other_tokens()
        # min-max normalization of float fields (recbole normalize_field /
        # normalize_all semantics)
        norm_fields = self.config["normalize_field"] or (
            [c for c in self.inter_feat.columns
             if self.field2type.get(c) == FeatureType.FLOAT
             and c not in (self.uid_field, self.iid_field)]
            if self.config["normalize_all"] else []
        )
        for field in norm_fields:
            if field in self.inter_feat.columns:
                v = self.inter_feat[field].to_numpy(np.float64)
                lo, hi = v.min(), v.max()
                if hi > lo:
                    self.inter_feat[field] = ((v - lo) / (hi - lo)).astype(np.float32)

        threshold = self.config["threshold"]
        if threshold:
            if len(threshold) != 1:
                raise ValueError("threshold length should be 1.")
            field, value = list(threshold.items())[0]
            if field not in self.inter_feat.columns:
                # recbole raises too; drop_filter_field + val_interval on the
                # same field removes it before the threshold can apply
                raise ValueError(f"Field [{field}] not in inter_feat.")
            self.inter_feat[self.label_field] = (
                self.inter_feat[field].to_numpy() >= value
            ).astype(np.float32)
            if field != self.label_field:
                self.inter_feat = self.inter_feat.drop(columns=[field])

        # prefix every field with the domain name so one batch can carry both
        # domains simultaneously (reference `dataset.py:57-82`)
        prefix = self.domain + "_"
        self.uid_field = prefix + self.config["USER_ID_FIELD"]
        self.iid_field = prefix + self.config["ITEM_ID_FIELD"]
        self.label_field = prefix + self.config["LABEL_FIELD"]
        if self.time_field:
            self.time_field = prefix + self.time_field
        for feat in (self.inter_feat, self.user_feat, self.item_feat):
            if feat is not None:
                feat.columns = [prefix + c for c in feat.columns]
        for d in (self.field2type, self.field2source, self.field2token_id, self.field2id_token):
            for key in list(d.keys()):
                d[prefix + key] = d.pop(key)

        self.arrays = {
            self.uid_field: self.inter_feat[self.uid_field].to_numpy(np.int64),
            self.iid_field: self.inter_feat[self.iid_field].to_numpy(np.int64),
        }
        if self.label_field in self.inter_feat.columns:
            self.arrays[self.label_field] = self.inter_feat[self.label_field].to_numpy(np.float32)
        if self.time_field and self.time_field in self.inter_feat.columns:
            self.arrays[self.time_field] = self.inter_feat[self.time_field].to_numpy(np.float32)

    # ------------------------------------------------------------------ stats

    def num(self, field: str) -> int:
        """Size of a token field's ID space."""
        if field in self.field2id_token:
            return len(self.field2id_token[field])
        raise ValueError(f"field [{field}] not a known token field.")

    @property
    def inter_num(self) -> int:
        return len(self.inter_feat)

    def __len__(self):
        return self.inter_num

    # ------------------------------------------------------- split / matrices

    def shuffled_order(self) -> np.ndarray:
        return np.random.permutation(self.inter_num)

    def split_by_ratio_grouped(self, ratios: List[float], order: np.ndarray):
        """Group rows by user (encounter order after ``order`` permutation) and
        split each group by ``ratios`` (recbole grouped split semantics)."""
        tot = sum(ratios)
        ratios = [r / tot for r in ratios]
        uid = self.arrays[self.uid_field][order]
        n_parts = len(ratios)
        part_indices = [[] for _ in range(n_parts)]
        # group indices by uid preserving encounter order
        group_order: Dict[int, list] = {}
        for pos, u in enumerate(uid):
            group_order.setdefault(u, []).append(order[pos])
        for u, idxs in group_order.items():
            split_ids = calcu_split_ids(len(idxs), ratios)
            bounds = [0] + split_ids + [len(idxs)]
            for p in range(n_parts):
                part_indices[p].extend(idxs[bounds[p]:bounds[p + 1]])
        return [np.array(p, dtype=np.int64) for p in part_indices]

    def split_by_ratio_flat(self, ratios: List[float], order: np.ndarray):
        tot = sum(ratios)
        ratios = [r / tot for r in ratios]
        split_ids = calcu_split_ids(len(order), ratios)
        bounds = [0] + split_ids + [len(order)]
        return [order[bounds[p]:bounds[p + 1]] for p in range(len(ratios))]

    def split_by_leave_one_out(self, mode: str, order: np.ndarray):
        """Leave-one-out split grouped by user (recbole 1.0.1 ``LS`` split
        semantics): users with <= leave_one_num rows keep everything in
        train; otherwise the last ``leave_one_num`` rows (in ``order``) are
        held out in order. Returns [train, valid, test] index arrays (valid
        or test empty per ``mode``)."""
        if mode not in ("valid_and_test", "valid_only", "test_only"):
            raise NotImplementedError(
                f"The leave_one_mode [{mode}] has not been implemented."
            )
        leave_one_num = 2 if mode == "valid_and_test" else 1
        uid = self.arrays[self.uid_field][order]
        groups: Dict[int, list] = {}
        for pos, u in enumerate(uid):
            groups.setdefault(u, []).append(order[pos])
        parts = [[] for _ in range(leave_one_num + 1)]
        for idxs in groups.values():
            if len(idxs) <= leave_one_num:
                parts[0].extend(idxs)
            else:
                parts[0].extend(idxs[:-leave_one_num])
                for i in range(1, leave_one_num + 1):
                    parts[i].append(idxs[-leave_one_num + i - 1])
        parts = [np.array(p, dtype=np.int64) for p in parts]
        empty = np.array([], dtype=np.int64)
        if mode == "valid_and_test":
            return [parts[0], parts[1], parts[2]]
        if mode == "valid_only":
            return [parts[0], parts[1], empty]
        return [parts[0], empty, parts[1]]

    def build_split(self, eval_args: dict, key: str = "split"):
        """Split this domain's interactions into parts per ``eval_args``.

        Returns a list of :class:`InteractionTable`.
        """
        ordering = eval_args["order"]
        if ordering == "RO":
            order = self.shuffled_order()
        elif ordering == "TO":
            if self.time_field not in self.inter_feat.columns:
                raise ValueError("TO ordering requires a time field.")
            order = np.argsort(
                self.inter_feat[self.time_field].to_numpy(), kind="stable"
            )
        else:
            raise NotImplementedError(f"The ordering_method [{ordering}] has not been implemented.")

        split_args = eval_args[key]
        if not isinstance(split_args, dict):
            raise ValueError(f"The split_args [{split_args}] should be a dict.")
        split_mode = list(split_args.keys())[0]
        group_by = eval_args["group_by"]
        if split_mode == "RS":
            if group_by is None or str(group_by).lower() == "none":
                parts = self.split_by_ratio_flat(split_args["RS"], order)
            elif group_by == "user":
                parts = self.split_by_ratio_grouped(split_args["RS"], order)
            else:
                raise NotImplementedError(f"The grouping method [{group_by}] has not been implemented.")
        elif split_mode == "LS":
            if group_by != "user":
                raise ValueError("Leave-one-out split (LS) requires grouping by user.")
            parts = self.split_by_leave_one_out(split_args["LS"], order)
        else:
            raise NotImplementedError(f"The splitting_method [{split_mode}] has not been implemented.")
        return [self.subset(p) for p in parts]

    def subset(self, row_indices: np.ndarray) -> "InteractionTable":
        return InteractionTable(
            {k: v[row_indices] for k, v in self.arrays.items()},
            uid_field=self.uid_field,
            iid_field=self.iid_field,
            label_field=self.label_field,
            neg_prefix=self.neg_prefix,
        )

    def full_table(self) -> "InteractionTable":
        return InteractionTable(
            dict(self.arrays),
            uid_field=self.uid_field,
            iid_field=self.iid_field,
            label_field=self.label_field,
            neg_prefix=self.neg_prefix,
        )

    def get_sparse_matrix(self, user_num, item_num, form="coo", value_field=None):
        """Sparse user x item interaction matrix over the unified ID space
        (reference `dataset.py:151-186`). It holds every interaction of the
        domain, the valid and test splits' included: splitting builds new
        tables and leaves ``arrays`` whole."""
        src = self.arrays[self.uid_field]
        tgt = self.arrays[self.iid_field]
        if value_field is None:
            data = np.ones(len(src))
        else:
            if value_field not in self.arrays:
                raise ValueError(f"Value_field [{value_field}] should be one of inter fields.")
            data = self.arrays[value_field]
        mat = coo_matrix((data, (src, tgt)), shape=(user_num, item_num))
        if form == "coo":
            return mat
        if form == "csr":
            return mat.tocsr()
        raise NotImplementedError(f"Sparse matrix format [{form}] has not been implemented.")

    def get_history_matrix(self, user_num, item_num, row="user", value_field=None, max_len=None):
        """Padded dense history matrix (reference `dataset.py:188-249`):
        (history_matrix, history_value, history_len). Like
        :meth:`get_sparse_matrix` it reads the whole domain, evaluation
        interactions included; each row keeps its first ``max_len`` entries
        in the stable order of ``arrays``."""
        user_ids = self.arrays[self.uid_field]
        item_ids = self.arrays[self.iid_field]
        values = (
            np.ones(len(user_ids))
            if value_field is None
            else self.arrays[value_field].astype(np.float64)
        )
        if row == "user":
            row_num, row_ids, col_ids = user_num, user_ids, item_ids
        else:
            row_num, row_ids, col_ids = item_num, item_ids, user_ids

        history_len = np.bincount(row_ids, minlength=row_num).astype(np.int64)
        col_num = int(history_len.max()) if len(history_len) else 0
        if max_len is not None:
            col_num = min(col_num, max_len)

        # stable sort rows; positions within each row via cumcount
        order = np.argsort(row_ids, kind="stable")
        sorted_rows = row_ids[order]
        starts = np.zeros(row_num + 1, dtype=np.int64)
        np.cumsum(history_len, out=starts[1:])
        pos_within = np.arange(len(sorted_rows)) - starts[sorted_rows]

        keep = pos_within < col_num
        history_matrix = np.zeros((row_num, col_num), dtype=np.int64)
        history_value = np.zeros((row_num, col_num), dtype=np.float64)
        history_matrix[sorted_rows[keep], pos_within[keep]] = col_ids[order][keep]
        history_value[sorted_rows[keep], pos_within[keep]] = values[order][keep]
        if max_len is not None:
            history_len = np.minimum(history_len, max_len)
        return history_matrix, history_value, history_len


class InteractionTable:
    """A split of interactions as a dict of aligned numpy arrays — the
    host-side analogue of a recbole ``Dataset`` after ``_change_feat_format``."""

    def __init__(self, arrays: Dict[str, np.ndarray], uid_field, iid_field, label_field, neg_prefix):
        self.arrays = arrays
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.label_field = label_field
        self.neg_prefix = neg_prefix

    def __len__(self):
        return len(self.arrays[self.uid_field])

    def __getitem__(self, field):
        return self.arrays[field]


class OverlapTable:
    """Synthetic dataset of overlapped-entity IDs ``arange(num_overlap)``,
    shuffled per epoch (reference ``CrossDomainOverlapDataset``,
    `recbole_cdr/data/dataset.py:657-707`)."""

    overlap_id_field = "overlap"

    def __init__(self, num_overlap: int):
        self.num_overlap = num_overlap
        self.ids = np.arange(num_overlap, dtype=np.int64)
        np.random.shuffle(self.ids)

    def shuffle(self):
        np.random.shuffle(self.ids)

    def __len__(self):
        return self.num_overlap


class CrossDomainDataset:
    """Loads the source and target domains, aligns overlapped entities, and
    remaps all IDs into the unified sectioned space (see module docstring).

    Mirrors ``CrossDomainDataset`` (`recbole_cdr/data/dataset.py:293-654`).
    """

    def __init__(self, config):
        assert "source_domain" in config and "target_domain" in config
        self.config = config
        self.logger = getLogger()
        self.train_modes = config["train_modes"]

        source_config = config.update(config["source_domain"])
        self.source_domain_dataset = DomainDataset(source_config, domain="source")
        target_config = config.update(config["target_domain"])
        self.target_domain_dataset = DomainDataset(target_config, domain="target")

        self.user_link_dict = None
        self.item_link_dict = None
        self._load_links(config["user_link_file_path"], config["item_link_file_path"])
        self.source_domain_dataset.apply_token_link(self.user_link_dict, self.item_link_dict)

        self._compute_unified_id_space()
        self.source_domain_dataset.finalize()
        self.target_domain_dataset.finalize()

        if self.num_overlap_user > 1:
            self.overlap_dataset = OverlapTable(self.num_overlap_user)
        else:
            self.overlap_dataset = OverlapTable(self.num_overlap_item)
        self.overlap_id_field = self.overlap_dataset.overlap_id_field

    # ------------------------------------------------------------------ links

    def _load_links(self, user_link_path, item_link_path):
        fs = self.config["field_separator"] or "\t"
        enc = self.config["encoding"] or "utf-8"
        if user_link_path:
            df = load_link_file(user_link_path, fs, enc)
            sf = self.source_domain_dataset.uid_field
            tf = self.target_domain_dataset.uid_field
            for field in {sf, tf}:
                assert field in df.columns, f"link data between users requires field [{field}]"
            self.user_link_dict = dict(zip(df[sf].to_numpy(), df[tf].to_numpy()))
        if item_link_path:
            df = load_link_file(item_link_path, fs, enc)
            sf = self.source_domain_dataset.iid_field
            tf = self.target_domain_dataset.iid_field
            for field in {sf, tf}:
                assert field in df.columns, f"link data between item requires field [{field}]"
            self.item_link_dict = dict(zip(df[sf].to_numpy(), df[tf].to_numpy()))

    # ----------------------------------------------------------- unified space

    @staticmethod
    def _section(source_set, target_set):
        """Compute (overlap, target_only, source_only) sorted token lists."""
        overlap = sorted(source_set & target_set)
        source_only = sorted(source_set - target_set)
        target_only = sorted(target_set - source_set)
        return overlap, target_only, source_only

    def _compute_unified_id_space(self):
        src_users, src_items = self.source_domain_dataset.token_sets()
        tgt_users, tgt_items = self.target_domain_dataset.token_sets()

        ov_u, tgt_only_u, src_only_u = self._section(src_users, tgt_users)
        ov_i, tgt_only_i, src_only_i = self._section(src_items, tgt_items)

        self.num_overlap_user = len(ov_u) + 1  # [PAD] counted
        self.num_target_only_user = len(tgt_only_u)
        self.num_source_only_user = len(src_only_u)
        self.num_total_user = (
            self.num_overlap_user + self.num_source_only_user + self.num_target_only_user
        )

        self.num_overlap_item = len(ov_i) + 1
        self.num_target_only_item = len(tgt_only_i)
        self.num_source_only_item = len(src_only_i)
        self.num_total_item = (
            self.num_overlap_item + self.num_source_only_item + self.num_target_only_item
        )

        def build_maps(overlap, target_only, source_only, n_overlap, n_target_only, n_total):
            overlap_map = {tok: i for i, tok in enumerate(overlap, start=1)}
            overlap_map["[PAD]"] = 0
            target_map = dict(overlap_map)
            target_map.update(
                {tok: i for i, tok in enumerate(target_only, start=n_overlap)}
            )
            source_map = dict(overlap_map)
            source_map.update(
                {tok: i for i, tok in enumerate(source_only, start=n_overlap + n_target_only)}
            )
            # id -> token lists per domain (PAD at 0)
            source_tokens = ["[PAD]"] + overlap + source_only
            target_tokens = ["[PAD]"] + overlap + target_only
            return source_map, target_map, source_tokens, target_tokens

        (src_u_map, tgt_u_map, src_u_tokens, tgt_u_tokens) = build_maps(
            ov_u, tgt_only_u, src_only_u,
            self.num_overlap_user, self.num_target_only_user, self.num_total_user,
        )
        (src_i_map, tgt_i_map, src_i_tokens, tgt_i_tokens) = build_maps(
            ov_i, tgt_only_i, src_only_i,
            self.num_overlap_item, self.num_target_only_item, self.num_total_item,
        )

        self.source_user_ID_remap_dict = src_u_map
        self.source_item_ID_remap_dict = src_i_map
        self.target_user_ID_remap_dict = tgt_u_map
        self.target_item_ID_remap_dict = tgt_i_map

        self.source_domain_dataset.remap_to_ids(src_u_map, src_i_map, src_u_tokens, src_i_tokens)
        self.target_domain_dataset.remap_to_ids(tgt_u_map, tgt_i_map, tgt_u_tokens, tgt_i_tokens)

    # ------------------------------------------------------------- matrices

    def inter_matrix(self, form="coo", value_field=None, domain="source"):
        ds = self.source_domain_dataset if domain == "source" else self.target_domain_dataset
        return ds.get_sparse_matrix(self.num_total_user, self.num_total_item, form, value_field)

    def history_item_matrix(self, value_field=None, domain="source", max_len=None):
        ds = self.source_domain_dataset if domain == "source" else self.target_domain_dataset
        return ds.get_history_matrix(
            self.num_total_user, self.num_total_item, row="user",
            value_field=value_field, max_len=max_len,
        )

    def history_user_matrix(self, value_field=None, domain="source", max_len=None):
        ds = self.source_domain_dataset if domain == "source" else self.target_domain_dataset
        return ds.get_history_matrix(
            self.num_total_user, self.num_total_item, row="item",
            value_field=value_field, max_len=max_len,
        )

    # ------------------------------------------------------------------ build

    def build(self):
        """Split per eval settings. Returns
        ``[source_train, source_valid_or_None, target_train, target_valid, target_test]``
        (reference `dataset.py:545-568`)."""
        eval_args = self.config["eval_args"]
        target_parts = self.target_domain_dataset.build_split(eval_args, key="split")
        tgt_train, tgt_valid, tgt_test = target_parts

        if not self.config["source_split"]:
            src_train = self.source_domain_dataset.full_table()
            return [src_train, None, tgt_train, tgt_valid, tgt_test]
        src_parts = self.source_domain_dataset.build_split(
            {**eval_args, "split_valid": eval_args.get("split_valid") or {"RS": [0.8, 0.2]}},
            key="split_valid",
        )
        src_train, src_valid = src_parts
        return [src_train, src_valid, tgt_train, tgt_valid, tgt_test]

    def __str__(self):
        return "\n".join(
            [
                f"Source domain: {self.source_domain_dataset.dataset_name} "
                f"({self.source_domain_dataset.inter_num} inters)",
                f"Target domain: {self.target_domain_dataset.dataset_name} "
                f"({self.target_domain_dataset.inter_num} inters)",
                f"Num of overlapped user: {self.num_overlap_user}",
                f"Num of overlapped item: {self.num_overlap_item}",
            ]
        )
