#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``recbole_cdr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build: compile every CUDA kernel of ``recbole_cdr_tpu_torch/csrc`` with
   nvcc (in parallel) and report the seconds and the card;
2. kernel checks: at the shapes of the main path below, hold each kernel
   against its plain PyTorch version (integer outputs exactly, the float
   gather-dot within the stated tolerance) and take the device time of the
   kernel, the plain version and, where one exists, the comparable single
   PyTorch call (``ms``, ``plain_ms``, ``library_ms``: calls queued behind
   a spin kernel and timed by CUDA events, or, for a function that waits on
   the device, torch.profiler kernel durations; see ``device_ms``), and the
   kernel's time per back-to-back call including launch overhead
   (``call_ms``, from CUDA events);
   B5 and B6 are held and timed at the catalog path's shapes (phase 4):
   B5's ids exactly on integer-valued factors, its scores within
   ``B5_TOL`` on normal ones; B6, over ``B6_STEPS`` steps on one scratch,
   within ``B6_TOL`` of its plain version and of ``torch.optim.SparseAdam``;
3. dense path: ``run_recbole_cdr(model="CMF")`` on the card, BOTH:3 with
   validation every epoch, on a synthetic pair of the benchmark's shape
   (source 30k users / 8k items / 600k interactions, target 12k / 5k / 250k,
   2k shared items, generated with numpy from a fixed seed into
   ``build/smoke_data``); K1-K4 must each launch, B5 and B6 never, the
   metrics be finite and the loss fall from epoch 0 to 2;
4. catalog path: ``run_recbole_cdr(model="CMF")`` with ``phase_optimizer:
   sparse``, BOTH:2 with validation every epoch, on a synthetic catalog pair
   (source 100k users / 300k items / 2M interactions, target 60k / 1.1M /
   2.4M, 20k shared items, every item in at least one interaction, per-user
   degree capped at 400, generated into ``build/smoke_catalog``): the target
   item space exceeds the default ``streaming_topk_threshold`` of 1e6, so
   every validation and the test pass stream through B5, and training steps
   through B6. K1-K3, B5 and B6 must each launch, K4 never; no table
   gradient may exist; the run's peak allocation up to each validation must
   stay under the parameters and moments plus 2 GB; the metrics must be
   finite and the loss fall from epoch 0 to 1;
5. BiTGCF path: ``run_recbole_cdr(model="BiTGCF")`` on the card, BOTH:3 with
   validation every epoch, on the dense path's pair at BiTGCF's published
   width (embedding 64, 2 layers, concat, dropout 0.3): K1-K4 and both B8
   wrappers must launch, B5 and B6 never; B8 exactly 4 forward and 4
   backward launches per training step (2 layers x 2 domains) and 4 forward
   per evaluation pass (one propagation per pass, not per user tile, the
   test pass included after the best parameters are loaded); the metrics
   must be finite and the loss fall from epoch 0 to 2;
6. NATR path: ``run_recbole_cdr(model="NATR")`` on the card at NATR's
   published width (source and target embedding 64, ``max_inter_length``
   50, ``reg_weight`` 1e-3) on the dense path's pair, which overlaps on
   items (so the users are the anchors), SOURCE:2 then TARGET:3 with
   validation every epoch and GAUC among the metrics, the best parameters
   reloaded for the test pass: K1 exactly once forward and once backward per
   SOURCE step and never elsewhere; B9's forward and backward once per
   TARGET step; B9's anchor table once per TARGET evaluation pass (each
   validation sees new parameters, the test pass the reloaded best ones) and
   its pair grid once per user tile of every TARGET validation and of the
   test pass (the predict fallback's tiles of ``user_batch`` rows); K4 and
   B7 once per tile of every validation and of the test pass; B5, B6 and B8
   never; the loss falls within each phase, every metric is finite and GAUC
   lies in (0, 1);
7. DTCDR paths: ``run_recbole_cdr(model="DTCDR")`` on the card at DTCDR's
   published width (``properties/model/DTCDR.yaml``: embedding 64,
   ``mlp_hidden_size`` [32, 16], dropout 0.1, alpha 0.5) on the dense path's
   pair, four runs: (a) NeuMF, BOTH:3, full-sort through the predict
   fallback with GAUC: K2, K3, K4 and B7 launch, B11 never; (b) DMF, BOTH:3,
   the same: B11 forward and backward exactly 4 times per training step
   (one launch per linear table over both domains' pairs), the forward 4
   more per evaluation pass (the tower tables, once per parameter version:
   3 validations + 1 test), K4 and B7 once per fallback tile; (c) DMF,
   BOTH:2, eval mode ``uniform 100``: B10 and B7's candidate form exactly
   once per candidate batch of every pass, K4 and B7's full-sort form
   never, and a test hit@10 above (b)'s; (d) DMF, BOTH:2, eval mode
   ``labeled`` (``threshold`` rating >= 4, AUC, MAE, RMSE, LogLoss): no
   evaluation kernel, AUC in [0, 1], RMSE >= MAE >= 0, LogLoss finite. In
   every run B5, B6, B8 and B9 never launch, the loss falls and the
   metrics are finite;
8. mapping paths: ``run_recbole_cdr`` on the card for the three mapping
   models on the dense path's pair at their published widths
   (``properties/model/*.yaml``), every phase cut to 2 epochs:
   (a) DCDCSR (64, MLP [128], k 10, ``map_batch_size`` 1024), SOURCE,
   TARGET, BOTH, TARGET: the BPR phases on the pairwise stream (K1 forward
   and backward once per step, K2 and K3 once per epoch), BOTH on the host
   batch path with no validation, B12 exactly once (on entry into BOTH);
   (b) EMCDR (64 / 64, ``non_linear``, MLP [128], CE, ``reg_weight`` 1e-2,
   ``overlap_batch_size`` 100), SOURCE, TARGET, OVERLAP: K1 once per MF
   step, K3 once per OVERLAP epoch (the OVERLAP stream) and K2 never there;
   (c) SSCDR (64, lambda 0.25, margin 1, MLP [128], ``overlap_batch_size``
   100), SOURCE, TARGET, OVERLAP: the triplet phases on the pairwise stream,
   OVERLAP on the host path (neighbours drawn on the host). In every run K4
   once per evaluation tile, the other kernels never, the loss falls within
   every phase and the metrics are finite. B12 is then held against its
   plain version on the run's own tables at BOTH entry (ids exact wherever
   the k-th and (k+1)-th similarity differ by more than ``B12_GAP``, the
   all-zero rows' ids 0..k-1, the rows within ``B12_TOL``) and timed with
   its bound, plain and library times;
9. report: the card's name and power limit, one JSON line of per-kernel
   numbers (launches per path), and the final ``{"ok": true, ...}`` line.

B8 (``graph_layer_forward`` / ``graph_layer_backward``) is held in phase 2
at the bench pair's source graph (about 50,400 rows and 441,000 nonzeros,
D = 64, dropout 0.3 from random bits): within ``B8_TOL`` of its plain
version, and two kernel runs bit-equal (a gather with no atomics). Its bytes
bound charges the unique bytes (CSR, x, bits, the other dense operands, the
outputs), not the nnz x D row gathers, which hit the L2 (x is 12.9 MB of its
50 MB).

B7 (``rank_sum``) is held in phase 2 on the dense path's first validation
tile ([2,048, 5,001]) with integer-valued scores (ties everywhere) and with
the unit-scale scores K4 sees, a row without positives, a positive inside
its row's history and one on the PAD column: equal to its plain version and
to JAX's method (a row sort and two searchsorted, the library yardstick),
and two kernel runs equal. B9 (``natr_attention_forward`` /
``natr_attention_backward``) is held at a TARGET step's shapes (8,192
pairs, H = 50, D = 64) in both overlap modes (user anchors with their item
histories, item anchors with their user histories), empty-history anchors
included, within ``B9_TOL`` of its plain version, and two kernel runs
bit-equal; its full-sort form (``natr_full_sort``: the anchor table, then
the pair grid) on one tile of the predict fallback ([32 users, the target
item space]) in both modes, within ``B9_TOL["full_sort"]`` of the one-call
plain version and bit-equal from run to run; the anchor table alone over
every target user (the NATR run's anchor count) and the pair grid alone on
that tile, each timed. B5's bound is its 3xTF32 products on the tensor
cores; the CUDA-core bound of its first design is kept as
``scalar_bound_ms``. B9's bounds charge the least work that computes the
same function (``natr_work``): the transfer once per distinct source row
the anchors gather (the kernel runs it once per slot of every pair's
anchor in training, and of every anchor of the table), the scores, softmax and
weighted sum once per slot of a distinct anchor, the pair stage once per
pair. K4 and B7 are also held and timed on that tile's probabilities, the
shape of most of their launches on the NATR path, under the record's
``shapes``.

B11 (``rating_vector_forward`` / ``rating_vector_backward``) is held in
phase 2 at a DMF training step's shapes (16,384 ids, both domains' pairs)
on each of its four histories, the source item side (every id's history of
source users, N ~ 27.8k) timed, and at the tower tables' shape (every target
item), within ``B11_TOL`` of its plain version; two backward runs within it
too (atomics), the error of each element against the sum of its terms'
absolute values. Its bound charges the distinct rows' work: each distinct
id's history entries and the table rows they name read once, the ids, the
output and one add per entry and column. B10 (``candidate_topk``) and B7's
candidate form (``rank_sum_candidates``) are held exactly at the shape of
phase 7c's candidate batches ([users per batch, max positives x 101]) with
integer-valued (ties everywhere) and normal scores.

``python3 chip_smoke.py --profile`` instead times one warm training epoch
and one validation pass of the dense path's run, then traces a repeat of
each with ``torch.profiler`` and prints the device time by kernel, the
device-busy share of the unprofiled wall time, and the path of the Chrome
trace it writes under ``chiprun_out/``; then it times one more warm epoch in
the same, now profiled, process. It does the same for the BiTGCF path, for
the NATR path (a SOURCE epoch and its validation, then a TARGET epoch and
its validation), and for DTCDR's NeuMF, DMF and DMF ``uniform 100`` runs
and the catalog path without writing their traces (the copy-back is
bounded); and for the mapping models' phases, each entered after the
phases before it in the schedule: DCDCSR's TARGET (the pairwise stream)
and BOTH (the host batch path, which has no validation), EMCDR's OVERLAP
(the OVERLAP stream), SSCDR's OVERLAP (the host path).

Nothing here imports jax or the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, "build", "smoke_data")
CATALOG_DIR = os.path.join(REPO, "build", "smoke_catalog")

N_SRC_USERS, N_SRC_ITEMS, N_SRC_INTER = 30000, 8000, 600000
N_TGT_USERS, N_TGT_ITEMS, N_TGT_INTER = 12000, 5000, 250000
N_SHARED_ITEMS = 2000
BATCH = 8192
EPOCHS = 3

#: the catalog pair: (users, items, interactions) per domain, shared items
CATALOG_SRC = (100_000, 300_000, 2_000_000)
CATALOG_TGT = (60_000, 1_100_000, 2_400_000)
CATALOG_SHARED_ITEMS = 20_000
CATALOG_DEGREE_CAP = 400
CATALOG_EPOCHS = 2
#: per-validation device memory allowed above the parameters and moments
CATALOG_EVAL_HEADROOM = 2 * 2 ** 30

#: the kernels each path must launch; the other kernels must not launch
DENSE_PATH = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
              "masked_topk")
CATALOG_PATH = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
                "streaming_topk", "sparse_adam")
BITGCF_PATH = DENSE_PATH + ("graph_layer_forward", "graph_layer_backward")
NATR_PATH = DENSE_PATH + ("rank_sum", "natr_attention_forward", "natr_attention_backward",
                          "natr_anchor_table", "natr_pair_grid")

#: NATR's epochs per phase, (SOURCE, TARGET), cut from its published 300 / 300
NATR_EPOCHS = (2, 3)
NATR_METRICS = ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]

#: B8 launches per training step and per evaluation pass: 2 layers x 2 domains
B8_PER_PROPAGATION = 4

#: DTCDR's runs of phase 7: (name, base model, eval mode, BOTH epochs), the
#: epochs cut from the published 300
DTCDR_RUNS = (("dtcdr_neumf", "NeuMF", "full", 3), ("dtcdr_dmf", "DMF", "full", 3),
              ("dtcdr_uniform", "DMF", "uniform 100", 2),
              ("dtcdr_labeled", "DMF", "labeled", 2))
DTCDR_LABELED_METRICS = ["AUC", "MAE", "RMSE", "LogLoss"]
#: the kernels each DTCDR run may and must launch
DTCDR_PATHS = {
    "dtcdr_neumf": ("neg_sampler", "swap_or_not", "masked_topk", "rank_sum"),
    "dtcdr_dmf": ("neg_sampler", "swap_or_not", "masked_topk", "rank_sum",
                  "rating_vector_forward", "rating_vector_backward"),
    "dtcdr_uniform": ("neg_sampler", "swap_or_not", "candidate_topk", "rank_sum_candidates",
                      "rating_vector_forward", "rating_vector_backward"),
    "dtcdr_labeled": ("neg_sampler", "swap_or_not", "rating_vector_forward",
                      "rating_vector_backward"),
}
#: B11 launches per DMF training step (forward and backward) and per
#: evaluation pass (forward): one per linear table
B11_PER_STEP = 4

#: phase 8's runs: (name, model, schedule), each phase cut to
#: ``MAPPING_EPOCHS`` epochs from the published 300 (DCDCSR's BOTH: 50)
MAPPING_EPOCHS = 2
MAPPING_RUNS = (("dcdcsr", "DCDCSR", ("SOURCE", "TARGET", "BOTH", "TARGET")),
                ("emcdr", "EMCDR", ("SOURCE", "TARGET", "OVERLAP")),
                ("sscdr", "SSCDR", ("SOURCE", "TARGET", "OVERLAP")))
#: the published widths of each (``properties/model/<model>.yaml``)
MAPPING_WIDTHS = {
    "DCDCSR": {"latent_factor_model": "BPR", "embedding_size": 64, "mlp_hidden_size": [128],
               "k": 10, "map_batch_size": 1024},
    "EMCDR": {"latent_factor_model": "MF", "loss_type": "CE", "source_embedding_size": 64,
              "target_embedding_size": 64, "reg_weight": 1e-2,
              "mapping_function": "non_linear", "mlp_hidden_size": [128],
              "overlap_batch_size": 100},
    "SSCDR": {"embedding_size": 64, "lambda": 0.25, "margin": 1, "mlp_hidden_size": [128],
              "overlap_batch_size": 100},
}
MAPPING_PATHS = {
    "dcdcsr": ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
               "masked_topk", "benchmark_topk"),
    "emcdr": ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
              "masked_topk"),
    "sscdr": ("neg_sampler", "swap_or_not", "masked_topk"),
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the float32 rate of
#: the CUDA cores, used as the rate of the kernels' 32-bit scalar operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
#: and the dense TF32 tensor-core rate: B5 scores in 3xTF32, three TF32
#: products (2 D flops each) per float32 score
PEAK_TF32_OPS_PER_S = 495e12
TF32_PRODUCTS_PER_SCORE = 3

#: K1 tolerance, |kernel - plain| <= ATOL + RTOL * max|plain|: the forward
#: sums the D products in another order than torch; the backward adds with
#: atomics in a run-dependent order over every pair that shares a row
K1_TOL = {"forward": (1e-4, 1e-5), "backward": (1e-3, 1e-5)}

#: B5 score tolerance on normal factors, (atol, rtol): the kernel's fixed
#: d-order FMA chain and torch.matmul add the 64 products in different
#: orders; ids must agree wherever neighbouring scores differ by more
B5_TOL = (1e-4, 1e-5)

#: B6 tolerance on p, mu and nu after ``B6_STEPS`` steps, |got - ref| <=
#: ATOL * max|ref| + RTOL * |ref| per tensor: the gradients are unit-scale
#: multiples of 1/64, so the coalesced sums are exact in any order and only
#: the moment and update formulas round (torch.optim.SparseAdam folds the
#: bias corrections in float64 and updates the moments as old + (1-b)(g-old))
B6_TOL = (1e-6, 1e-5)
B6_STEPS = 3

#: B8 tolerance, |kernel - plain| <= ATOL + RTOL * max|plain|: the kernel's
#: FMA chain in CSR order and index_add_'s atomics add a row's products in
#: different orders
B8_TOL = {"forward": (1e-5, 1e-5), "backward": (1e-5, 1e-5)}
B8_DROP = 0.3

#: B9 tolerance per output tensor, |kernel - plain| <= ATOL + RTOL * max|plain|:
#: the kernel and torch sum the transfer's 64 products, the scores, the
#: softmax and the blends in other orders (forward, and the full-sort
#: probabilities); the weight gradients are sums over all 8,192 pairs x 50
#: slots, which the kernel adds per block and then block by block, and
#: autograd in its own order (backward)
B9_TOL = {"forward": (1e-5, 1e-4), "full_sort": (1e-6, 1e-4), "backward": (1e-5, 1e-3)}

#: B11 tolerance per output element, |kernel - plain| <= ATOL + RTOL * the
#: sum of the absolute values of the terms the element adds: the kernel sums
#: a row in pieces of 32 entries added by atomics (the backward also adds
#: every id's gradient into shared rows by atomics), index_add_ in its own
#: order, and two float32 sums of the same terms in any two orders differ by
#: a small multiple of 2^-24 times that sum (RTOL is 64 of them)
B11_TOL = (1e-6, 2 ** -18)


#: B12 tolerance on a benchmark row, |kernel - plain| <= ATOL + RTOL * |plain|,
#: where the row's k-th and (k+1)-th similarity differ by more than
#: ``B12_GAP`` (nearer ties may order differently: the kernel adds a
#: similarity's D products in d order, cuBLAS in its own); ids equal there
#: as sets, and position by position on all-zero rows (every similarity 0)
B12_TOL = (1e-5, 1e-5)
B12_GAP = 1e-5


#: cycles of the spin kernel that holds the stream while the host queues
#: the calls it times (about 0.1 s at the H100's clock)
SPIN_CYCLES = 200_000_000

#: prefix of the line on which the kernel-check child reports its records
_RECORDS = "KERNEL_RECORDS "


def gen_data():
    """The benchmark pair as atomic files (zipf-ish degrees, per-user degree
    capped at 5% of the item space), made once from numpy seed 7."""
    import numpy as np

    marker = os.path.join(DATA_DIR, ".done_v1")
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(7)

    def gen(name, prefix, n_users, n_items, n_inter, item_tokens):
        uids = rng.zipf(1.3, n_inter * 2) % n_users + 1
        iids = rng.zipf(1.2, n_inter * 2) % n_items
        keep = np.unique(np.stack([uids, iids]), axis=1)[:, :n_inter]
        uids, iids = keep[0], keep[1]
        cap = max(50, n_items // 20)
        order = np.argsort(uids, kind="stable")
        uids, iids = uids[order], iids[order]
        starts = np.searchsorted(uids, np.arange(uids.max() + 2))
        sel = (np.arange(len(uids)) - starts[uids]) < cap
        uids, iids = uids[sel], iids[sel]
        ratings = rng.integers(1, 6, len(uids))
        d = os.path.join(DATA_DIR, name)
        os.makedirs(d, exist_ok=True)
        rows = [f"{prefix}_{u}\t{item_tokens[i]}\t{r}" for u, i, r in
                zip(uids.tolist(), iids.tolist(), ratings.tolist())]
        with open(os.path.join(d, f"{name}.inter"), "w") as f:
            f.write("user_id:token\titem_id:token\trating:float\n")
            f.write("\n".join(rows) + "\n")

    shared = [f"item_{i}" for i in range(N_SHARED_ITEMS)]
    gen("bench-src", "su", N_SRC_USERS, N_SRC_ITEMS, N_SRC_INTER,
        shared + [f"src_item_{i}" for i in range(N_SRC_ITEMS - N_SHARED_ITEMS)])
    gen("bench-tgt", "tu", N_TGT_USERS, N_TGT_ITEMS, N_TGT_INTER,
        shared + [f"tgt_item_{i}" for i in range(N_TGT_ITEMS - N_SHARED_ITEMS)])
    open(marker, "w").write("ok")


def gen_catalog():
    """The catalog pair as atomic files, made once from numpy seed 13: one
    interaction per item (so the whole item space survives the id remap, as
    in ``bench.py``'s large-item pair), the rest with mildly skewed users and
    items, deduplicated, per-user degree capped at ``CATALOG_DEGREE_CAP``."""
    import numpy as np
    import pandas as pd

    marker = os.path.join(CATALOG_DIR, ".done_v1")
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(13)

    def gen(name, prefix, n_users, n_items, n_inter, item_tokens):
        base_u = rng.integers(1, n_users + 1, n_items)
        base_i = np.arange(n_items)
        extra = n_inter - n_items
        ex_u = np.clip((1 + n_users * rng.random(extra) ** 1.5).astype(np.int64), 1, n_users)
        ex_i = (n_items * rng.random(extra) ** 2.5).astype(np.int64)
        base_keys = base_u.astype(np.int64) * n_items + base_i
        keys = np.unique(np.concatenate([base_keys, ex_u * n_items + ex_i]))
        uids, iids = keys // n_items, keys % n_items
        is_base = np.zeros(len(keys), bool)
        is_base[np.searchsorted(keys, base_keys)] = True
        order = np.lexsort((~is_base, uids))  # per user: its item-covering rows first
        uids, iids, is_base = uids[order], iids[order], is_base[order]
        starts = np.searchsorted(uids, np.arange(n_users + 2))
        keep = ((np.arange(len(uids)) - starts[uids]) < CATALOG_DEGREE_CAP) | is_base
        uids, iids = uids[keep], iids[keep]
        d = os.path.join(CATALOG_DIR, name)
        os.makedirs(d, exist_ok=True)
        pd.DataFrame({
            "user_id:token": np.char.add(prefix + "_", uids.astype(str)),
            "item_id:token": np.asarray(item_tokens)[iids],
            "rating:float": rng.integers(1, 6, len(uids)),
        }).to_csv(os.path.join(d, f"{name}.inter"), sep="\t", index=False)

    shared = [f"item_{i}" for i in range(CATALOG_SHARED_ITEMS)]
    n_users, n_items, n_inter = CATALOG_SRC
    gen("cat-src", "su", n_users, n_items, n_inter,
        shared + [f"src_item_{i}" for i in range(n_items - CATALOG_SHARED_ITEMS)])
    n_users, n_items, n_inter = CATALOG_TGT
    gen("cat-tgt", "tu", n_users, n_items, n_inter,
        shared + [f"tgt_item_{i}" for i in range(n_items - CATALOG_SHARED_ITEMS)])
    open(marker, "w").write("ok")


def catalog_config():
    """The catalog path: CMF at its published width, SparseAdam, the default
    streaming threshold (1e6), float32."""
    cfg = config_dict()
    cfg.update({
        "train_epochs": [f"BOTH:{CATALOG_EPOCHS}"],
        "phase_optimizer": "sparse",
        "embedding_size": 64,
        "compute_dtype": "float32",
        "source_dataset": "cat-src",
        "target_dataset": "cat-tgt",
        "source_data_path": CATALOG_DIR,
        "target_data_path": CATALOG_DIR,
        "checkpoint_dir": os.path.join(CATALOG_DIR, "saved"),
        "log_dir": os.path.join(CATALOG_DIR, "log"),
    })
    return cfg


def bitgcf_config():
    """The BiTGCF path: the dense path's pair at BiTGCF's published width
    (``properties/model/BiTGCF.yaml``: embedding 64, 2 layers, concat,
    dropout 0.3), the best parameters reloaded for the test pass."""
    return {**config_dict(), "embedding_size": 64, "n_layers": 2, "connect_way": "concat",
            "drop_rate": B8_DROP}


def natr_config():
    """The NATR path: the dense path's pair at NATR's published width
    (``properties/model/NATR.yaml``), SOURCE then TARGET, GAUC among the
    metrics, the best parameters reloaded for the test pass."""
    return {**config_dict(), "source_embedding_size": 64, "target_embedding_size": 64,
            "max_inter_length": 50, "reg_weight": 1e-3, "metrics": NATR_METRICS,
            "topk": [10],
            "train_epochs": [f"SOURCE:{NATR_EPOCHS[0]}", f"TARGET:{NATR_EPOCHS[1]}"]}


def dtcdr_config(base_model, mode, epochs):
    """A DTCDR run of phase 7: the dense path's pair at DTCDR's published
    width, BOTH:``epochs``, eval mode ``mode`` (``full``, ``uniform N`` or
    ``labeled``) on the default RS 0.8 / 0.1 / 0.1 split."""
    cfg = {**config_dict(), "embedding_size": 64, "mlp_hidden_size": [32, 16],
           "dropout_prob": 0.1, "alpha": 0.5, "base_model": base_model,
           "train_epochs": [f"BOTH:{epochs}"], "metrics": NATR_METRICS, "topk": [10],
           "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "RO",
                         "mode": mode}}
    if mode == "labeled":
        cfg.update(threshold={"rating": 4}, metrics=DTCDR_LABELED_METRICS, valid_metric="AUC")
    return cfg


def mapping_config(model, schedule):
    """A phase-8 run: the dense path's pair at ``model``'s published width,
    every phase of ``schedule`` for ``MAPPING_EPOCHS`` epochs."""
    return {**config_dict(), **MAPPING_WIDTHS[model],
            "train_epochs": [f"{p}:{MAPPING_EPOCHS}" for p in schedule]}


def config_dict():
    return {
        "device": "cuda",
        "state": "INFO",
        "show_progress": False,
        "train_batch_size": BATCH,
        "eval_batch_size": 65536,
        "train_epochs": [f"BOTH:{EPOCHS}"],
        "eval_step": 1,
        "source_dataset": "bench-src",
        "target_dataset": "bench-tgt",
        "source_data_path": DATA_DIR,
        "target_data_path": DATA_DIR,
        "source_user_inter_num_interval": "[1,inf)",
        "source_item_inter_num_interval": "[1,inf)",
        "target_user_inter_num_interval": "[1,inf)",
        "target_item_inter_num_interval": "[1,inf)",
        "source_val_interval": None,
        "target_val_interval": None,
        "checkpoint_dir": os.path.join(DATA_DIR, "saved"),
        "log_dir": os.path.join(DATA_DIR, "log"),
    }


def _device_events(prof):
    """Device-side activity of a trace (kernels and copies), without the GPU
    spans of user annotations."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, reps=20, warmup=3):
    """(mean device milliseconds per call of ``fn`` after ``warmup`` calls,
    the method: "queued" or "profiler").

    A spin kernel holds the stream while the host queues ``reps`` calls, so
    CUDA events around them time the device running the calls back to back
    rather than the host's launch rate. A function whose host code waits on
    the device releases the spin before the queue is full; it is timed by the
    summed kernel and copy durations of a torch.profiler trace instead (a
    trace can lose whole launches, which undercounts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    queued = not start.query()  # the spin still runs: every call is queued
    end.record()
    torch.cuda.synchronize()
    if queued:
        return start.elapsed_time(end) / reps, "queued"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    assert events, "the profiler recorded no device activity"
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3, "profiler"


def call_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` issued back to back, CUDA events
    around the run: the larger of the device time and the host's launch
    overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops, tf32_ops=0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak, ``n_ops`` 32-bit scalar
    operations on the CUDA cores plus ``tf32_ops`` on the tensor cores."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_ops / PEAK_SCALAR_OPS_PER_S + tf32_ops / PEAK_TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_recorder(out):
    """``record(name, kernel_fn, plain_fn, equal, n_bytes, n_ops, ...)``:
    times a kernel, its plain version and its library call and keeps the
    record under ``out[name]``."""

    def record(name, kernel_fn, plain_fn, equal, n_bytes, n_ops, library_fn=None, reps=20,
               shape=None, tf32_ops=0):
        """Time a kernel, its plain version and its library call; with
        ``shape``, as a second shape of an already recorded kernel, kept
        under the record's ``shapes``."""
        b_ms, b_by = bound(n_bytes, n_ops, tf32_ops)
        timed = {"ms": device_ms(kernel_fn, reps),
                 "plain_ms": device_ms(plain_fn, max(3, reps // 4), 1)}
        if library_fn:
            timed["library_ms"] = device_ms(library_fn, reps)
        rec = {
            "max_abs_err": equal,
            "ms": timed["ms"][0],
            "plain_ms": timed["plain_ms"][0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed["library_ms"][0] if library_fn else None,
            "call_ms": call_ms(kernel_fn, reps),
            "timing": {k: how for k, (_, how) in timed.items()},
        }
        if shape:
            out[name].setdefault("shapes", {})[shape] = rec
        else:
            out[name] = rec
        print(f"  {name}{f' {shape}' if shape else ''}: max_abs_err {equal:.3g}  kernel {rec['ms']:.4f} ms  "
              f"plain {rec['plain_ms']:.4f} ms  library "
              f"{'-' if rec['library_ms'] is None else format(rec['library_ms'], '.4f')} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  per call {rec['call_ms']:.4f} ms  "
              f"timing {rec['timing']}", flush=True)

    return record


def kernel_checks(dev):
    """Hold K1-K4 against their plain versions at the dense path's shapes,
    B5 and B6 at the catalog path's, and time them. Returns {kernel name:
    record}."""
    import numpy as np
    import torch

    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.evaluator.evaluator import (
        FullSortEvaluator,
        _fused_eval_arrays,
        _padded_positives,
    )
    from recbole_cdr_tpu_torch.ops import gather_dot as k1, masked_topk as k4
    from recbole_cdr_tpu_torch.ops import rank_sum as b7
    from recbole_cdr_tpu_torch.ops import graph_layer as b8
    from recbole_cdr_tpu_torch.ops import neg_sampler as k2, shuffle as k3
    from recbole_cdr_tpu_torch.ops import sparse_adam as b6, topk as b5
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    config = CDRConfig(model="CMF", config_dict=config_dict(), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, valid_data, _ = data_preparation(config, dataset)
    src_ = TorchRandomSource(0, dev)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"],
                           1, dataset.num_total_user, src_, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    record = make_recorder(out)

    # ---- K3: the epoch shuffle of both domains, one whole epoch ----------
    n_steps = loop.steps_per_epoch
    shuf = loop._shuffle_material(0)
    s = torch.arange(n_steps, device=dev)
    c = s // loop.src_batches_per_cycle
    slots = (s % loop.src_batches_per_cycle)[:, None] * loop.src_step + torch.arange(loop.src_step, device=dev)
    x_src = torch.where(slots < loop.src.n, slots, 0).to(torch.int32)
    keys_src, salts_src = shuf["src"][0][c], shuf["src"][1][c]
    slots_t = s[:, None] * loop.step + torch.arange(loop.step, device=dev)
    x_tgt = torch.where(slots_t < loop.tgt.n, slots_t, 0).to(torch.int32)
    keys_tgt, salts_tgt = shuf["tgt"]
    a = k3.swap_or_not(x_src, loop.src.n, keys_src, salts_src)
    b = k3.swap_or_not_plain(x_src, loop.src.n, keys_src, salts_src)
    a2 = k3.swap_or_not(x_tgt, loop.tgt.n, keys_tgt, salts_tgt)
    b2 = k3.swap_or_not_plain(x_tgt, loop.tgt.n, keys_tgt, salts_tgt)
    err = max(int((a - b).abs().max()), int((a2 - b2).abs().max()))
    assert err == 0, "swap_or_not disagrees with its plain version"
    n3 = x_src.numel()
    record("swap_or_not",
           lambda: k3.swap_or_not(x_src, loop.src.n, keys_src, salts_src),
           lambda: k3.swap_or_not_plain(x_src, loop.src.n, keys_src, salts_src),
           float(err), 8 * n3 + keys_src.numel() * 8, n3 * k3.SHUFFLE_ROUNDS * 12)

    # ---- K2: the source domain's negatives for one whole epoch ----------
    uid = loop.src.uid[a.long()].reshape(-1)
    base = torch.randint(-2 ** 31, 2 ** 31, (uid.shape[0],), dtype=torch.int32,
                         device=dev, generator=g)
    hist, ranges = loop.src.hist, loop.src.cand_ranges
    a = k2.sample_negatives(base, uid, hist, ranges, 1)
    b = k2.sample_negatives_plain(base, uid, hist, ranges, 1)
    err = int((a - b).abs().max())
    assert err == 0, "neg_sampler disagrees with its plain version"
    T, H = uid.shape[0], hist.shape[1]
    n_users = int(torch.unique(uid).numel())
    record("neg_sampler",
           lambda: k2.sample_negatives(base, uid, hist, ranges, 1),
           lambda: k2.sample_negatives_plain(base, uid, hist, ranges, 1),
           float(err), 12 * T + 4 * n_users * H, T * k2.R_ROUNDS * (H + 12), reps=5)

    # ---- K1: one train step's pairs of both domains ---------------------
    U = torch.randn(dataset.num_total_user, config["embedding_size"], device=dev, generator=g)
    I = torch.randn(dataset.num_total_item, config["embedding_size"], device=dev, generator=g)
    xs = loop._build_xs(shuf, 0, 0, 1)
    uu = torch.cat([xs["source_user_id"][0], xs["target_user_id"][0]])
    ii = torch.cat([xs["source_item_id"][0], xs["target_item_id"][0]])
    gg = torch.randn(uu.shape[0], device=dev, generator=g)
    P, D = uu.shape[0], U.shape[1]
    rows = (torch.unique(uu).numel() + torch.unique(ii).numel()) * D * 4
    a = k1.gather_dot_forward(U, I, uu, ii)
    b = k1.gather_dot_plain(U, I, uu, ii)
    err = float((a - b).abs().max())
    atol, rtol = K1_TOL["forward"]
    assert err <= atol + rtol * float(b.abs().max()), f"gather_dot forward error {err}"
    record("gather_dot_forward",
           lambda: k1.gather_dot_forward(U, I, uu, ii),
           lambda: k1.gather_dot_plain(U, I, uu, ii),
           err, 8 * P + rows + 4 * P, 2 * P * D,
           library_fn=lambda: (U[uu] * I[ii]).sum(-1))
    dU, dI = k1.gather_dot_backward(U, I, uu, ii, gg)
    pU, pI = k1.gather_dot_backward_plain(U, I, uu, ii, gg)
    err = max(float((dU - pU).abs().max()), float((dI - pI).abs().max()))
    atol, rtol = K1_TOL["backward"]
    scale = max(float(pU.abs().max()), float(pI.abs().max()))
    assert err <= atol + rtol * scale, f"gather_dot backward error {err}"
    record("gather_dot_backward",
           lambda: k1.gather_dot_backward(U, I, uu, ii, gg),
           lambda: k1.gather_dot_backward_plain(U, I, uu, ii, gg),
           err, 12 * P + rows + (U.numel() + I.numel()) * 4, 4 * P * D)

    # ---- K4: one dense eval tile of the validation split ----------------
    ev = FullSortEvaluator(config)
    B, _ = ev._dense_budget(valid_data)
    uids, row_ptr, items = _fused_eval_arrays(valid_data, B, dev)
    users = uids[:B]
    n_target = dataset.num_overlap_item + dataset.num_target_only_item
    torch.backends.cuda.matmul.allow_tf32 = False
    scores = U[users] @ I[:n_target].T
    rp = row_ptr[0, :users.shape[0] + 1]
    k = ev.max_k
    a = k4.masked_topk(scores, rp, items[0], k)
    b = k4.masked_topk_plain(scores, rp, items[0], k)
    err = int((a - b).abs().max())
    assert err == 0, "masked_topk disagrees with its plain version"
    n_pairs = int(rp[-1])
    hist_t = history_pairs(rp, items[0])
    record("masked_topk",
           lambda: k4.masked_topk(scores, rp, items[0], k),
           lambda: k4.masked_topk_plain(scores, rp, items[0], k),
           float(err), scores.numel() * 4 + rp.numel() * 4 + n_pairs * 4 + users.shape[0] * k * 4,
           scores.numel(), library_fn=lambda: library_topk(scores, hist_t, k))

    # ---- B7: the GAUC rank sums of the same tile ---------------------------
    nB, n_items = users.shape[0], scores.shape[1]
    pos_all, pmask_all = _padded_positives(valid_data, dev)
    pos, pmask = pos_all[:nB].clone(), pmask_all[:nB].clone()
    pmask[1] = False                              # a row without positives
    pos[3, 0], pmask[3, 0] = 0, True              # the PAD column
    r = 4 + int(torch.nonzero(rp[5:] > rp[4:-1])[0])
    pos[r, 0], pmask[r, 0] = items[0][int(rp[r])], True  # a positive inside the history
    ties = torch.randint(-3, 4, scores.shape, device=dev, generator=g).float()
    for sc in (ties, scores):
        check_rank_sum(sc, rp, items[0], pos, pmask)
    print(f"  rank_sum: [{nB}, {n_items}], {int(pmask.sum())} positives in rows of up to "
          f"{pos.shape[1]}", flush=True)
    record("rank_sum",
           lambda: b7.rank_sum(ties, rp, items[0], pos, pmask),
           lambda: b7.rank_sum_plain(ties, rp, items[0], pos, pmask),
           0.0, ties.numel() * 4 + rp.numel() * 4 + n_pairs * 4 + pos.numel() * 5 + nB * 4,
           2 * n_items * int(pmask.sum()),
           library_fn=lambda: library_rank_sum(ties, rp, items[0], pos, pmask))
    del U, I, scores, ties

    # ---- B8: one graph layer of the source graph, forward and backward --
    csr, csr_t = (b8.CSR(*(t.to(dev) for t in b8.csr_from_scipy(m)))
                  for m in bitgcf_graph(dataset))
    N, D, nnz = csr.row_ptr.shape[0] - 1, 64, csr.col.shape[0]
    keep = 1.0 - B8_DROP
    x = 0.1 * torch.randn(N, D, device=dev, generator=g)
    gy = torch.randn(N, D, device=dev, generator=g)
    bits = torch.randint(-2 ** 31, 2 ** 31, (N, D), dtype=torch.int32, device=dev, generator=g)
    print(f"  graph_layer: N {N}, nnz {nnz}, D {D}, keep {keep}", flush=True)
    new, side = b8.graph_layer_forward(csr, x, bits, keep)
    p_new, p_side = b8.graph_layer_forward_plain(csr, x, bits, keep)
    err = max(float((new - p_new).abs().max()), float((side - p_side).abs().max()))
    atol, rtol = B8_TOL["forward"]
    scale = max(float(p_new.abs().max()), float(p_side.abs().max()))
    assert err <= atol + rtol * scale, f"graph_layer forward error {err}"
    new2, side2 = b8.graph_layer_forward(csr, x, bits, keep)
    assert torch.equal(new, new2) and torch.equal(side, side2), \
        "graph_layer forward differs run to run"
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        Ls, Ls_t = (torch.sparse_csr_tensor(m.row_ptr.long(), m.col.long(), m.val, (N, N),
                                            check_invariants=True) for m in (csr, csr_t))

    def library_forward():
        sd = torch.sparse.mm(Ls, x)
        return torch.where(b8.keep_mask(bits, keep), (x + sd + x * sd) / keep, 0.0), sd

    csr_bytes = 4 * (N + 1) + 8 * nnz
    record("graph_layer_forward",
           lambda: b8.graph_layer_forward(csr, x, bits, keep),
           lambda: b8.graph_layer_forward_plain(csr, x, bits, keep),
           err, csr_bytes + 4 * N * D * 4, 2 * nnz * D + 8 * N * D,
           library_fn=library_forward)
    gx = b8.graph_layer_backward(csr_t, x, side, bits, keep, gy)
    p_gx = b8.graph_layer_backward_plain(csr_t, x, side, bits, keep, gy)
    err = float((gx - p_gx).abs().max())
    atol, rtol = B8_TOL["backward"]
    assert err <= atol + rtol * float(p_gx.abs().max()), f"graph_layer backward error {err}"
    assert torch.equal(gx, b8.graph_layer_backward(csr_t, x, side, bits, keep, gy)), \
        "graph_layer backward differs run to run"

    def library_backward():
        gp = torch.where(b8.keep_mask(bits, keep), gy / keep, 0.0)
        return (gp + gp * side) + torch.sparse.mm(Ls_t, gp + gp * x)

    record("graph_layer_backward",
           lambda: b8.graph_layer_backward(csr_t, x, side, bits, keep, gy),
           lambda: b8.graph_layer_backward_plain(csr_t, x, side, bits, keep, gy),
           err, csr_bytes + 5 * N * D * 4, 2 * nnz * D + 12 * N * D,
           library_fn=library_backward)
    del x, gy, bits, new, side, new2, side2, p_new, p_side, gx, p_gx, Ls, Ls_t

    # ---- B9: NATR's attention at a TARGET step's and a full-sort tile's shapes
    natr_checks(dev, g, config, dataset, train_data, valid_data, record)

    # ---- B11, B10 and B7's candidate form at the DTCDR paths' shapes ----
    dtcdr_checks(dev, g, record)

    # ---- the catalog path's data ----------------------------------------
    cconfig = CDRConfig(model="CMF", config_dict=catalog_config(), _cli_args=[])
    init_seed(cconfig["seed"], True)
    cdataset = create_dataset(cconfig)
    ctrain, cvalid, _ = data_preparation(cconfig, cdataset)
    D = cconfig["embedding_size"]
    cev = FullSortEvaluator(cconfig)

    # ---- B5: one streaming tile of the validation split -----------------
    n_items = cvalid.item_num
    _, row_ptr, items = _fused_eval_arrays(cvalid, cev.STREAM_USER_BLOCK, dev)
    B = min(cev.STREAM_USER_BLOCK, len(cvalid.uid_list))
    rp, it = row_ptr[0, :B + 1], items[0]
    k = cev.max_k
    Ui = torch.randint(-3, 4, (B, D), device=dev, generator=g).float()
    Ti = torch.randint(-3, 4, (n_items, D), device=dev, generator=g).float()
    a, b = b5.streaming_topk(Ui, Ti, rp, it, k), b5.streaming_topk_plain(Ui, Ti, rp, it, k)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0]), \
        "streaming_topk disagrees with its plain version on integer-valued factors"
    del Ui, Ti
    Un = torch.randn(B, D, device=dev, generator=g)
    Tn = torch.randn(n_items, D, device=dev, generator=g)
    (a_s, a_i), (b_s, b_i) = (b5.streaming_topk(Un, Tn, rp, it, k),
                              b5.streaming_topk_plain(Un, Tn, rp, it, k))
    atol, rtol = B5_TOL
    tol = atol + rtol * b_s.abs()
    err = float((a_s - b_s).abs().max())
    assert bool(((a_s - b_s).abs() <= tol).all()), f"streaming_topk score error {err}"
    gap = torch.diff(b_s, dim=1).abs() > tol[:, 1:]
    clear = torch.ones_like(gap[:, :1])
    clear = torch.cat([clear, gap], 1) & torch.cat([gap, clear], 1)
    assert torch.equal(a_i[clear], b_i[clear]), "streaming_topk ids differ where scores do not tie"
    n_pairs = int(rp[-1])
    rows_h = torch.repeat_interleave(torch.arange(B, device=dev), (rp[1:] - rp[:-1]).long())
    it_h = it[:n_pairs].long()

    def library_streaming():
        sc = Un @ Tn.T  # [B, items]: 9 GB at the catalog's 1.1M items
        sc[rows_h, it_h] = torch.finfo(torch.float32).min
        sc[:, 0] = torch.finfo(torch.float32).min
        return torch.topk(sc, k, dim=1).indices

    b5_bytes = Tn.numel() * 4 + Un.numel() * 4 + (B + 1 + n_pairs) * 4 + B * k * 8
    record("streaming_topk",
           lambda: b5.streaming_topk(Un, Tn, rp, it, k),
           lambda: b5.streaming_topk_plain(Un, Tn, rp, it, k),
           err, b5_bytes, 0, library_fn=library_streaming, reps=10,
           tf32_ops=TF32_PRODUCTS_PER_SCORE * 2 * B * n_items * D)
    # the first design's bound, float32 FMAs on the CUDA cores, kept beside it
    out["streaming_topk"]["scalar_bound_ms"] = bound(b5_bytes, 2 * B * n_items * D)[0]
    print(f"  streaming_topk: [{B} x {D}] against [{n_items} x {D}], k {k}; bound on the "
          f"CUDA cores {out['streaming_topk']['scalar_bound_ms']:.4f} ms", flush=True)
    del Un, Tn

    # ---- B6: the item-table updates of three train steps -----------------
    cloop = DeviceEpochLoop(TrainMode.BOTH, None, ctrain, cconfig["MODEL_INPUT_TYPE"], 1,
                            cdataset.num_total_user, TorchRandomSource(1, dev), dev)
    cxs = cloop._build_xs(cloop._shuffle_material(0), 0, 0, B6_STEPS)
    step_ids = [torch.cat([cxs["source_item_id"][s], cxs["target_item_id"][s]]).to(torch.int32)
                for s in range(B6_STEPS)]
    del cloop, cxs
    N, R = cdataset.num_total_item, step_ids[0].shape[0]
    lr = float(cconfig["learning_rate"])
    P0 = 0.1 * torch.randn(N, D, device=dev, generator=g)
    grads = [torch.round(64 * torch.randn(R, D, device=dev, generator=g)) / 64
             for _ in range(B6_STEPS)]
    firstpos = b6.first_position_scratch(N, dev)
    kern = (P0.clone(), torch.zeros_like(P0), torch.zeros_like(P0))
    plain = (P0.clone(), torch.zeros_like(P0), torch.zeros_like(P0))
    tp = torch.nn.Parameter(P0.clone())
    topt = torch.optim.SparseAdam([tp], lr=lr)
    for c, (ids, G) in enumerate(zip(step_ids, grads), 1):
        step = b6.adam_step_size(lr, 0.9, 0.999, c)
        b6.sparse_adam(*kern, G, ids, step, firstpos=firstpos)
        b6.sparse_adam_plain(*plain, G, ids, step, 0.9, 0.999, 1e-8)
        tp.grad = torch.sparse_coo_tensor(ids.long()[None], G, (N, D))
        topt.step()
    st = topt.state[tp]
    atol, rtol = B6_TOL
    err = err_torch = 0.0
    for name, got, want, torch_want in zip(("p", "mu", "nu"), kern, plain,
                                           (tp.detach(), st["exp_avg"], st["exp_avg_sq"])):
        for ref_name, ref in (("plain", want), ("torch.optim.SparseAdam", torch_want)):
            diff = (got - ref).abs()
            assert bool((diff <= atol * float(ref.abs().max()) + rtol * ref.abs()).all()), \
                f"sparse_adam {name} against {ref_name}: error {float(diff.max())}"
        err = max(err, float((got - want).abs().max()))
        err_torch = max(err_torch, float((got - torch_want).abs().max()))
    print(f"  sparse_adam: {B6_STEPS} steps, max_abs_err against torch.optim.SparseAdam "
          f"{err_torch:.3g}", flush=True)
    assert bool((firstpos == b6.INT32_MAX).all()), "sparse_adam left its scratch dirty"
    ids, G = step_ids[0], grads[0]
    step = b6.adam_step_size(lr, 0.9, 0.999, 1)
    n_rows = int(torch.unique(ids).numel())
    record("sparse_adam",
           lambda: b6.sparse_adam(*kern, G, ids, step, firstpos=firstpos),
           lambda: b6.sparse_adam_plain(*plain, G, ids, step, 0.9, 0.999, 1e-8),
           err, G.numel() * 4 + R * 4 + 6 * n_rows * D * 4, n_rows * D * 12 + R * D,
           library_fn=topt.step)
    return out


def history_pairs(rp, items):
    """The (row, column) pairs of a tile's CSR history."""
    import torch

    rows = torch.repeat_interleave(torch.arange(rp.shape[0] - 1, device=rp.device),
                                   (rp[1:] - rp[:-1]).long())
    return rows, items[:int(rp[-1])].long()


def library_topk(scores, hist_pairs, k):
    """K4's library yardstick: the history and PAD scattered to finfo.min,
    then ``torch.topk``."""
    import torch

    sc = scores.clone()
    sc[hist_pairs] = torch.finfo(torch.float32).min
    sc[:, 0] = torch.finfo(torch.float32).min
    return torch.topk(sc, k, dim=1).indices


def library_rank_sum(scores, rp, items, pos, pmask):
    """B7's library yardstick, JAX's method: the masked row sorted, two
    searchsorted per positive."""
    import torch

    from recbole_cdr_tpu_torch.ops import rank_sum as b7

    m = b7.masked_scores_plain(scores, rp, items)
    asc = torch.sort(m, dim=1).values
    pv = torch.gather(m, 1, torch.where(pmask, pos, 0).long())
    left = torch.searchsorted(asc, pv)
    right = torch.searchsorted(asc, pv, right=True)
    avg = (scores.shape[1] - right).float() + ((right - left).float() + 1.0) / 2.0
    return torch.where(pmask, avg, 0.0).sum(1)


def check_rank_sum(scores, rp, items, pos, pmask):
    """B7 exactly equal to its plain version and to JAX's method, and two
    kernel runs equal."""
    import torch

    from recbole_cdr_tpu_torch.ops import rank_sum as b7

    a = b7.rank_sum(scores, rp, items, pos, pmask)
    b = b7.rank_sum_plain(scores, rp, items, pos, pmask)
    assert torch.equal(a, b), f"rank_sum disagrees with its plain version: {float((a - b).abs().max())}"
    assert torch.equal(a, library_rank_sum(scores, rp, items, pos, pmask)), \
        "rank_sum disagrees with JAX's method"
    assert torch.equal(a, b7.rank_sum(scores, rp, items, pos, pmask)), "rank_sum differs run to run"


def natr_work(n_rows, n_slots, n_pairs, D, backward=False):
    """Scalar operations of the least work that computes B9. The transfer
    ``h = src[r] @ W + b`` depends on the source row alone, so it is charged
    once per distinct source row the anchors gather (2 D^2 + D); the scores
    (4 D), the softmax (4) and the weighted sum (2 D) once per slot of a
    distinct anchor (``n_slots`` = distinct anchors x H); the pair stage once
    per pair, regrouped as the pair grid computes it: the products su_d q_d
    and pu_d q_d (2 D), their relus (2 D), the two gates' multiply-adds
    (4 D) and the two dots' adds on the same products (2 D), then 13
    constants (two bias adds and two exps, beta's sum and divide, 1 - beta,
    beta (su.q) + (1 - beta) (pu.q), the sigmoid's exp, add and divide).
    The backward recomputes that forward work and adds per
    distinct row the outer product of dW and db (2 D^2 + D), after each
    slot's d(h) is summed onto its row (D per slot); per slot the chain rule
    through the scores and the softmax (about 10 D); per pair the blend's
    chain rule (about 20 D)."""
    row = 2 * D * D + D
    slot = 6 * D + 4
    pair = 10 * D + 13
    if backward:
        row *= 2
        slot += 11 * D
        pair += 20 * D
    return n_rows * row + n_slots * slot + n_pairs * pair


def natr_checks(dev, g, config, dataset, train_data, valid_data, record):
    """Hold B9 against its plain version at a TARGET step's shapes and on a
    full-sort tile of the predict fallback, in both overlap modes, and time
    the overlap_items mode (the NATR path's); then hold and time K4 and B7 on
    that tile's probabilities, the shape of most of their NATR launches."""
    import numpy as np
    import torch

    from recbole_cdr_tpu_torch.evaluator.evaluator import (
        FullSortEvaluator,
        _fused_eval_arrays,
        _padded_positives,
    )
    from recbole_cdr_tpu_torch.ops import masked_topk as k4, rank_sum as b7
    from recbole_cdr_tpu_torch.ops import natr_attention as b9
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.trainer.trainer import make_predict_full_sort
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    D, H = 64, 50
    nu, ni = dataset.num_total_user, dataset.num_total_item
    n_target = dataset.num_overlap_item + dataset.num_target_only_item
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device=dev, generator=g)
    w = b9.Weights(rnd(D, D, scale=0.2), rnd(D, scale=0.1), rnd(D, 1, scale=0.3),
                   rnd(1, scale=0.1), rnd(D, 1, scale=0.3), rnd(1, scale=0.1))
    tables = {"tu": rnd(nu, D, scale=0.3), "ti": rnd(ni, D, scale=0.3),
              "su": rnd(nu, D, scale=0.3), "si": rnd(ni, D, scale=0.3)}
    tloop = DeviceEpochLoop(TrainMode.TARGET, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                            nu, TorchRandomSource(2, dev), dev)
    txs = tloop._build_xs(tloop._shuffle_material(0), 0, 0, 1)
    step_users, step_items = txs["target_user_id"][0], txs["target_item_id"][0]
    P = step_users.shape[0]
    gz = torch.randn(P, device=dev, generator=g)

    # one full-sort tile of the fallback: user_batch users x the items the
    # trainer hands predict_grid
    uids, fs_rp, fs_hist = _fused_eval_arrays(valid_data, valid_data.user_batch, dev)
    fs_users = uids[:valid_data.user_batch]

    class Grid:
        def predict_grid(self, users, items):
            self.items = items
            return torch.zeros(users.shape[0], items.shape[0], device=dev)

    grid = Grid()
    make_predict_full_sort(grid, n_target)(fs_users)
    grid_items = grid.items
    assert torch.equal(grid_items, torch.arange(n_target, device=dev))

    def close(got, want, tol, what):
        atol, rtol = tol
        err = float((got - want).abs().max())
        assert err <= atol + rtol * float(want.abs().max()), f"{what}: error {err}"
        return err

    for mode in ("overlap_items", "overlap_users"):
        items_mode = mode == "overlap_items"
        hm, _, lens = (dataset.history_item_matrix if items_mode
                       else dataset.history_user_matrix)(domain="target")
        hm, lens = hm[:, :H], np.minimum(lens, H)
        mask = np.arange(hm.shape[1])[None, :] < lens[:, None]
        hist = b9.History(tables["si" if items_mode else "su"],
                          torch.as_tensor(hm.astype(np.int32), device=dev),
                          torch.as_tensor(mask, device=dev))
        anchors = (step_users if items_mode else step_items).clone()
        # empty histories: PAD, and a source-only entity (no target interaction)
        anchors[:8], anchors[8:16] = 0, (nu if items_mode else ni) - 1
        assert not bool(hist.mask[anchors[:16].long()].any())
        own, other = ("tu", "ti") if items_mode else ("ti", "tu")
        pu = tables[own][anchors.long()]
        q = tables[other][(step_items if items_mode else step_users).long()]
        print(f"  natr_attention [{mode}]: P {P}, H {hm.shape[1]}, D {D}, "
              f"{int(torch.unique(anchors).numel())} distinct anchors", flush=True)

        a = b9.natr_attention_forward(hist, anchors, pu, q, w)
        b = b9.natr_attention_forward_plain(hist, anchors, pu, q, w)
        err_f = close(a, b, B9_TOL["forward"], f"natr_attention_forward [{mode}]")
        assert torch.equal(a, b9.natr_attention_forward(hist, anchors, pu, q, w)), \
            "natr_attention_forward differs run to run"
        ka = b9.natr_attention_backward(hist, anchors, pu, q, w, gz)
        pa = b9.natr_attention_backward_plain(hist, anchors, pu, q, w, gz)
        names = ("dpu", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da")
        err_b = 0.0
        for name, x, y in zip(names, ka, pa):
            if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
                assert float(x.abs().max()) <= B9_TOL["backward"][0], f"db_da {float(x)}"
                continue
            err_b = max(err_b, close(x, y, B9_TOL["backward"], f"natr_attention_backward {name} [{mode}]"))
        again = b9.natr_attention_backward(hist, anchors, pu, q, w, gz)
        assert all(torch.equal(x, y) for x, y in zip(ka, again)), \
            "natr_attention_backward differs run to run"

        # the full-sort tile: anchors on the rows (users) or the columns (items)
        if items_mode:
            fa, fp, fq = fs_users.to(torch.int32), tables["tu"][fs_users], tables["ti"][grid_items]
        else:
            fa, fp, fq = grid_items.to(torch.int32), tables["ti"][grid_items], tables["tu"][fs_users]
        c = b9.natr_full_sort(hist, fa, fp, fq, w, items_mode)
        d = b9.natr_full_sort_plain(hist, fa, fp, fq, w, items_mode)
        assert c.shape == (fs_users.shape[0], grid_items.shape[0])
        err_s = close(c, d, B9_TOL["full_sort"], f"natr_full_sort [{mode}]")
        assert torch.equal(c, b9.natr_full_sort(hist, fa, fp, fq, w, items_mode))
        print(f"  natr_attention [{mode}]: max_abs_err forward {err_f:.3g}, backward "
              f"{err_b:.3g}, full-sort {err_s:.3g}", flush=True)
        if not items_mode:
            continue

        n_anchor = int(torch.unique(anchors).numel())
        rows = int(torch.unique(hist.ids[torch.unique(anchors).long()]).numel())
        fixed = 4 * (D * D + 3 * D + 2)
        fwd_bytes = n_anchor * H * 5 + rows * D * 4 + 2 * P * D * 4 + P * 8 + fixed
        print(f"  natr_attention: {n_anchor} distinct anchors gather {rows} distinct "
              f"source rows", flush=True)
        record("natr_attention_forward",
               lambda: b9.natr_attention_forward(hist, anchors, pu, q, w),
               lambda: b9.natr_attention_forward_plain(hist, anchors, pu, q, w),
               err_f, fwd_bytes, natr_work(rows, n_anchor * H, P, D))
        record("natr_attention_backward",
               lambda: b9.natr_attention_backward(hist, anchors, pu, q, w, gz),
               lambda: b9.natr_attention_backward_plain(hist, anchors, pu, q, w, gz),
               err_b, fwd_bytes + P * 4 + 2 * P * D * 4 + fixed,
               natr_work(rows, n_anchor * H, P, D, backward=True))
        # the anchor table as the NATR run builds it: every target user at once
        tds = dataset.target_domain_dataset
        n_tu = tds.num(tds.uid_field)
        every = torch.arange(n_tu, dtype=torch.int32, device=dev)
        t_pu = tables["tu"][:n_tu]
        table = b9.natr_anchor_table(hist, every, t_pu, w)
        err_t = close(table, b9.anchor_plain(hist, every, t_pu, w), B9_TOL["forward"],
                      "natr_anchor_table")
        assert torch.equal(table, b9.natr_anchor_table(hist, every, t_pu, w)), \
            "natr_anchor_table differs run to run"
        rows_t = int(torch.unique(hist.ids[every.long()]).numel())
        print(f"  natr_anchor_table: {n_tu} anchors gather {rows_t} distinct source rows",
              flush=True)
        record("natr_anchor_table",
               lambda: b9.natr_anchor_table(hist, every, t_pu, w),
               lambda: b9.anchor_plain(hist, every, t_pu, w),
               err_t, n_tu * H * 5 + rows_t * D * 4 + 2 * n_tu * D * 4 + fixed,
               natr_work(rows_t, n_tu * H, 0, D), reps=10)
        # the pair grid of one fallback tile, from the table's rows
        B = fs_users.shape[0]
        su_t = table[fs_users.long()]
        g_k = b9.natr_pair_grid(su_t, fp, fq, w, True)
        err_g = close(g_k, b9.pair_grid_plain(su_t, fp, fq, w, True), B9_TOL["full_sort"],
                      "natr_pair_grid")
        assert torch.equal(g_k, b9.natr_pair_grid(su_t, fp, fq, w, True)), \
            "natr_pair_grid differs run to run"
        record("natr_pair_grid",
               lambda: b9.natr_pair_grid(su_t, fp, fq, w, True),
               lambda: b9.pair_grid_plain(su_t, fp, fq, w, True),
               err_g, (2 * B + n_target) * D * 4 + B * n_target * 4 + 4 * (D + 1),
               natr_work(0, 0, B * n_target, D), reps=50)
        fs_probs = c

    # ---- K4 and B7 on the fallback tile's probabilities ------------------
    B = fs_users.shape[0]
    rp, it = fs_rp[0, :B + 1], fs_hist[0]
    k = FullSortEvaluator(config).max_k
    a = k4.masked_topk(fs_probs, rp, it, k)
    assert torch.equal(a, k4.masked_topk_plain(fs_probs, rp, it, k)), \
        "masked_topk disagrees with its plain version on the fallback tile"
    pos_all, pmask_all = _padded_positives(valid_data, dev)
    pos, pmask = pos_all[:B], pmask_all[:B]
    check_rank_sum(fs_probs, rp, it, pos, pmask)
    n_pairs = int(rp[-1])
    hp = history_pairs(rp, it)
    tile = f"[{B}, {n_target}]"
    print(f"  fallback tile {tile}: {int(pmask.sum())} positives, {n_pairs} history entries",
          flush=True)
    record("masked_topk",
           lambda: k4.masked_topk(fs_probs, rp, it, k),
           lambda: k4.masked_topk_plain(fs_probs, rp, it, k),
           0.0, fs_probs.numel() * 4 + rp.numel() * 4 + n_pairs * 4 + B * k * 4,
           fs_probs.numel(), library_fn=lambda: library_topk(fs_probs, hp, k), shape=tile)
    record("rank_sum",
           lambda: b7.rank_sum(fs_probs, rp, it, pos, pmask),
           lambda: b7.rank_sum_plain(fs_probs, rp, it, pos, pmask),
           0.0, fs_probs.numel() * 4 + rp.numel() * 4 + n_pairs * 4 + pos.numel() * 5 + B * 4,
           2 * n_target * int(pmask.sum()),
           library_fn=lambda: library_rank_sum(fs_probs, rp, it, pos, pmask), shape=tile)


def dtcdr_checks(dev, g, record):
    """Hold B11 against its plain version at a DMF training step's shapes on
    its four histories and at the tower tables' shape, and time the source
    item side; hold and time B10 and B7's candidate form at the shape of
    phase 7c's candidate batches."""
    import numpy as np
    import torch

    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
    from recbole_cdr_tpu_torch.ops import candidate_topk as b10
    from recbole_cdr_tpu_torch.ops import rank_sum as b7
    from recbole_cdr_tpu_torch.ops import rating_vector as b11
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    _, base, mode, _ = DTCDR_RUNS[2]
    config = CDRConfig(model="DTCDR", config_dict=dtcdr_config(base, mode, 1), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, valid_data, _ = data_preparation(config, dataset)
    model = DTCDR(config, dataset).to(dev)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(3, dev), dev)
    xs = loop._build_xs(loop._shuffle_material(0), 0, 0, 1)
    users = torch.cat([xs["source_user_id"][0], xs["target_user_id"][0]]).to(torch.int32)
    items = torch.cat([xs["source_item_id"][0], xs["target_item_id"][0]]).to(torch.int32)
    D = config["embedding_size"]

    def close(got, want, absum, what):
        """B11_TOL against ``absum``, the same sums over the terms' absolute
        values."""
        atol, rtol = B11_TOL
        diff = (got - want).abs()
        used = float((diff / (atol + rtol * absum)).max())
        assert used <= 1.0, f"{what}: error {float(diff.max())}, {used:.3g} of the tolerance"
        print(f"  {what}: max_abs_err {float(diff.max()):.3g}, {used:.3g} of the tolerance",
              flush=True)
        return float(diff.max())

    def b11_work(csr, ids):
        """(distinct ids, their entries, distinct table rows they name)."""
        uniq = torch.unique(ids)
        owner, entry = b11._expand(csr, uniq)
        rows = int(torch.unique(csr.cols[entry]).numel())
        return int(uniq.numel()), int(entry.numel()), rows

    errs = {"forward": 0.0, "backward": 0.0}
    timed = None
    for name, table, ids in (("s_items", model.source_user_linear, users),
                             ("t_items", model.target_user_linear, users),
                             ("s_users", model.source_item_linear, items),
                             ("t_users", model.target_item_linear, items)):
        csr = model._csr(name)
        N = table.shape[0]
        x = 0.3 * torch.randn(N, D, device=dev, generator=g)
        gout = torch.randn(ids.shape[0], D, device=dev, generator=g)
        errs["forward"] = max(errs["forward"], close(
            b11.rating_vector_forward(csr, x, ids), b11.rating_vector_plain(csr, x, ids),
            b11.rating_vector_plain(csr, x.abs(), ids), f"rating_vector_forward [{name}]"))
        want = b11.rating_vector_backward_plain(csr, N, ids, gout)
        absum = b11.rating_vector_backward_plain(csr, N, ids, gout.abs())
        for run in ("", ", second run"):
            errs["backward"] = max(errs["backward"], close(
                b11.rating_vector_backward(csr, N, ids, gout), want, absum,
                f"rating_vector_backward [{name}{run}]"))
        n_ids, n_entries, n_rows = b11_work(csr, ids)
        print(f"  rating_vector [{name}]: {ids.shape[0]} ids, {n_ids} distinct, "
              f"{n_entries} history entries naming {n_rows} of [{N} x {D}]'s rows", flush=True)
        if name == "s_users":
            timed = (csr, x, ids, gout, N, n_ids, n_entries, n_rows)
    # the tower tables' shape: every target item on the source user side
    csr, x, _, _, N, _, _, _ = timed
    every = torch.arange(model.target_num_items, dtype=torch.int32, device=dev)
    errs["forward"] = max(errs["forward"], close(
        b11.rating_vector_forward(csr, x, every), b11.rating_vector_plain(csr, x, every),
        b11.rating_vector_plain(csr, x.abs(), every), "rating_vector_forward [tower table]"))

    csr, x, ids, gout, N, n_ids, n_entries, n_rows = timed
    B = ids.shape[0]
    owner, entry = b11._expand(csr, ids)
    flat = csr.cols[entry].long()
    lens = csr.ptr[ids.long() + 1] - csr.ptr[ids.long()]
    offsets = torch.cumsum(lens, 0) - lens
    vec = torch.zeros(B, N, device=dev)
    vec[owner, flat] = 1.0
    jax_ms = device_ms(lambda: vec @ x, 10)[0]
    csr_bytes = 8 * n_ids + 4 * n_entries
    record("rating_vector_forward",
           lambda: b11.rating_vector_forward(csr, x, ids),
           lambda: b11.rating_vector_plain(csr, x, ids),
           errs["forward"], n_rows * D * 4 + 4 * B + csr_bytes + B * D * 4, n_entries * D,
           library_fn=lambda: torch.nn.functional.embedding_bag(
               flat, x, offsets.long(), mode="sum"), reps=10)
    g_rows = gout[owner]
    record("rating_vector_backward",
           lambda: b11.rating_vector_backward(csr, N, ids, gout),
           lambda: b11.rating_vector_backward_plain(csr, N, ids, gout),
           errs["backward"], B * D * 4 + 4 * B + csr_bytes + N * D * 4, n_entries * D + B * D,
           library_fn=lambda: torch.zeros(N, D, device=dev).index_add_(0, flat, g_rows), reps=10)
    for name in ("rating_vector_forward", "rating_vector_backward"):
        print(f"  {name}: library yardstick "
              + ("embedding_bag(mode='sum')" if name.endswith("forward") else
                 "index_add_ of the prebuilt [entries, D] gradient rows")
              + f" over {int(flat.numel())} entries with repeats", flush=True)
    print(f"  rating_vector_forward: JAX's form (dense [{B} x {N}] vector @ table) "
          f"{jax_ms:.4f} ms", flush=True)
    del vec, g_rows, flat

    # ---- B10 and B7's candidate form on phase 7c's first candidate batch
    users_b, cand, cand_mask, pos_mask, n_real = next(iter(valid_data))
    B, C = cand.shape
    k = min(10, C)
    cm = torch.as_tensor(cand_mask, device=dev)
    pm = torch.as_tensor(pos_mask, device=dev)
    ties = torch.randint(-3, 4, (B, C), device=dev, generator=g).float()
    normal = torch.randn(B, C, device=dev, generator=g)
    for sc in (ties, normal):
        assert torch.equal(b10.candidate_topk(sc, cm, k), b10.candidate_topk_plain(sc, cm, k)), \
            "candidate_topk disagrees with its plain version"
        a = b7.rank_sum_candidates(sc, cm, pm)
        assert torch.equal(a, b7.rank_sum_candidates_plain(sc, cm, pm)), \
            "rank_sum_candidates disagrees with its plain version"
        assert torch.equal(a, library_rank_sum_candidates(sc, cm, pm)), \
            "rank_sum_candidates disagrees with JAX's method"
        assert torch.equal(a, b7.rank_sum_candidates(sc, cm, pm)), "rank_sum_candidates run to run"
    lib = torch.topk(torch.where(cm, normal, torch.finfo(torch.float32).min), k, dim=1)
    kth = lib.values[:, -1:]
    clear = (torch.where(cm, normal, torch.finfo(torch.float32).min) == kth).sum(1) == 1
    assert torch.equal(lib.indices[clear].int(), b10.candidate_topk(normal, cm, k)[clear]), \
        "candidate_topk disagrees with torch.topk on rows without ties at the k-th score"
    n_pos = int(pm.sum())
    print(f"  candidate batch [{B}, {C}]: {int(cm.sum())} candidates, {n_pos} positives, "
          f"k {k}", flush=True)
    record("candidate_topk",
           lambda: b10.candidate_topk(ties, cm, k),
           lambda: b10.candidate_topk_plain(ties, cm, k),
           0.0, B * C * 5 + B * k * 4, B * C,
           library_fn=lambda: torch.topk(
               torch.where(cm, ties, torch.finfo(torch.float32).min), k, dim=1).indices)
    record("rank_sum_candidates",
           lambda: b7.rank_sum_candidates(ties, cm, pm),
           lambda: b7.rank_sum_candidates_plain(ties, cm, pm),
           0.0, B * C * 6 + B * 4, 2 * C * n_pos,
           library_fn=lambda: library_rank_sum_candidates(ties, cm, pm))


def library_rank_sum_candidates(scores, cand_mask, pos_mask):
    """B7's candidate-form yardstick, JAX's method: the row (padded slots at
    -inf) sorted, two searchsorted per column, the positives' ranks
    summed."""
    import torch

    m = torch.where(cand_mask, scores, -torch.inf)
    asc = torch.sort(m, dim=1).values
    left = torch.searchsorted(asc, m)
    right = torch.searchsorted(asc, m, right=True)
    avg = (scores.shape[1] - right).float() + ((right - left).float() + 1.0) / 2.0
    return torch.where(pos_mask, avg, 0.0).sum(1)


def bitgcf_graph(dataset):
    """BiTGCF's normalised source adjacency of ``dataset`` and its
    transpose, as the model builds them (scipy, float32)."""
    import numpy as np

    from recbole_cdr_tpu_torch.models.bitgcf import _norm_adj

    inter = dataset.inter_matrix(form="coo", domain="source").astype(np.float32)
    L = _norm_adj(inter, dataset.num_total_user, dataset.num_total_item).astype(np.float32)
    return L, L.T


def profile_epoch(dev, cfg, tag="", export=True, model="CMF", scheme="BOTH", prelude=()):
    """Device time by kernel over one warm ``scheme`` epoch and one
    validation pass of ``model`` in the configuration ``cfg``; with
    ``export``, Chrome traces of both in the output directory (names
    prefixed by ``tag``). Each validation pass first marks the parameters
    updated, as a training step does, so that it rebuilds what the model
    caches per parameter version (NATR's anchor table, BiTGCF's
    propagation). The traced call follows one untraced warm-up step of the
    profiler and an idle pause, and the wrappers' launch counts of the
    traced call are printed beside the trace's, so that launches a trace
    lost show. The phases of ``prelude`` are entered first, untrained, with
    their parameter surgery (DCDCSR's BOTH follows its SOURCE and TARGET);
    a phase the trainer runs on the host batch path is profiled there, and
    one the model's trainer does not validate has no validation pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from recbole_cdr_tpu_torch import ops
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.utils import get_model, get_trainer, init_seed
    from recbole_cdr_tpu_torch.utils.enums import train_mode2state

    config = CDRConfig(model=model, config_dict=cfg, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, valid_data, _ = data_preparation(config, dataset)
    trainer = get_trainer(None, model)(config, get_model(model)(config, dataset))
    for phase in tuple(prelude) + (scheme,):
        train_data.set_mode(train_mode2state[phase])
        trainer.model.set_phase(phase)
        trainer.model.mutate_params_on_phase(phase)
    valid_data = trainer._route_valid(scheme, valid_data)
    if trainer._use_device_loop(scheme):
        loop = trainer._loop_for(scheme, train_data)
        run_epoch = lambda epoch: float(loop.run_epoch(epoch))
    else:
        step = trainer._step_fn_for(scheme)
        run_epoch = lambda epoch: float(trainer._host_epoch(scheme, train_data, step, epoch)[0])

    def valid_pass():
        trainer.model.notify_params_updated()
        trainer._evaluate_batches(scheme, valid_data)

    run_epoch(0)
    calls = [("train_epoch", lambda: run_epoch(1))]
    if valid_data is not None:
        valid_pass()
        calls.append(("valid_pass", valid_pass))
    torch.cuda.synchronize()
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for name, fn in calls:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3  # unprofiled
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            ops.reset_launch_counts()
            # a trace drops the device activity of its first milliseconds
            # (NATR's anchor table, the first tiles): give it idle time first
            time.sleep(0.1)
            fn()
            torch.cuda.synchronize()
            counted = {k: n for k, n in ops.launch_counts().items() if n}
            prof.step()
        events = _device_events(prof)
        busy_us, end = 0.0, float("-inf")
        for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in events):
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        by_name = {}
        for e in events:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        print(f"{tag}{name}: wall {wall_ms:.3f} ms unprofiled, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}% of the "
              "unprofiled wall)", flush=True)
        for key, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:100]}", flush=True)
        print(f"  the wrappers counted: {counted}", flush=True)
        if export:
            path = os.path.join(out_dir, f"torch_{tag}{name}_trace.json")
            prof.export_chrome_trace(path)
            print(f"  trace: {os.path.relpath(path, REPO)}", flush=True)
    t0 = time.perf_counter()
    run_epoch(2)
    print(f"{tag}train_epoch after profiling, same process: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms unprofiled", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from recbole_cdr_tpu_torch import ops, run_recbole_cdr
    from recbole_cdr_tpu_torch.ops import build

    dev = torch.device("cuda")
    if "--kernel-checks" in sys.argv[1:]:
        gen_data()
        gen_catalog()
        print(_RECORDS + json.dumps(kernel_checks(dev)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({len(build.SOURCES)} nvcc processes in parallel)", flush=True)
    for name, log in build.build_logs.items():  # ptxas: registers, spills per kernel
        usage = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"  {name}.cu: " + "; ".join(usage), flush=True)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    gen_data()
    print(f"synthetic pair ready in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gen_catalog()
    print(f"catalog pair ready in {time.perf_counter() - t0:.1f} s", flush=True)
    if "--profile" in sys.argv[1:]:
        profile_epoch(dev, config_dict())
        profile_epoch(dev, bitgcf_config(), "bitgcf_", model="BiTGCF")
        for scheme in ("SOURCE", "TARGET"):
            profile_epoch(dev, natr_config(), f"natr_{scheme.lower()}_", model="NATR",
                          scheme=scheme)
        for name, base, mode, epochs in DTCDR_RUNS[:3]:
            profile_epoch(dev, dtcdr_config(base, mode, epochs), f"{name}_", export=False,
                          model="DTCDR")
        for model, scheme, prelude in (("DCDCSR", "TARGET", ("SOURCE",)),
                                       ("DCDCSR", "BOTH", ("SOURCE", "TARGET")),
                                       ("EMCDR", "OVERLAP", ("SOURCE", "TARGET")),
                                       ("SSCDR", "OVERLAP", ("SOURCE", "TARGET"))):
            schedule = next(r[2] for r in MAPPING_RUNS if r[1] == model)
            profile_epoch(dev, mapping_config(model, schedule),
                          f"{model.lower()}_{scheme.lower()}_", export=False, model=model,
                          scheme=scheme, prelude=prelude)
        profile_epoch(dev, catalog_config(), "catalog_", export=False)  # traces of ~100 MB
        return 0

    # the checks time the kernels under torch.profiler; they run in a child
    # process so that the paths below are timed in a process the profiler
    # never ran in (``--profile`` times a warm epoch before and after tracing)
    print("== phase 2: kernel checks at the paths' shapes", flush=True)
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel-checks"],
                           stdout=subprocess.PIPE, text=True, check=True)
    records = None
    for line in child.stdout.splitlines():
        if line.startswith(_RECORDS):
            records = json.loads(line[len(_RECORDS):])
        else:
            print(line, flush=True)
    assert records is not None, "the kernel checks reported no records"
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 3: dense path, run_recbole_cdr(model='CMF') on the card", flush=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="CMF", config_dict=config_dict(), saved=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"dense": ops.launch_counts()}
    hist = _report_run(result, wall, counts["dense"], DENSE_PATH)
    assert len(hist) == EPOCHS and hist[-1]["loss"] < hist[0]["loss"], hist

    print("== phase 4: catalog path, run_recbole_cdr(model='CMF', phase_optimizer='sparse') "
          "with streaming evaluation", flush=True)
    # each validation records the process's peak allocation so far, an upper
    # bound of its own: count it from this run
    del result
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="CMF", config_dict=catalog_config(), saved=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["catalog"] = ops.launch_counts()
    hist = _report_run(result, wall, counts["catalog"], CATALOG_PATH)
    model = result["model"]
    assert all(p.grad is None for p in model.parameters()), "a table gradient was allocated"
    state = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"parameters + moments {state / 2 ** 30:.3f} GiB; peak allocation up to each "
          "validation " + ", ".join(f"{h['valid_peak_bytes'] / 2 ** 30:.3f} GiB" for h in hist),
          flush=True)
    assert all(h["valid_peak_bytes"] - state < CATALOG_EVAL_HEADROOM for h in hist), hist
    assert len(hist) == CATALOG_EPOCHS and hist[1]["loss"] < hist[0]["loss"], hist

    print("== phase 5: BiTGCF path, run_recbole_cdr(model='BiTGCF') on the card", flush=True)
    del result, model
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="BiTGCF", config_dict=bitgcf_config(), saved=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["bitgcf"] = c = ops.launch_counts()
    hist = _report_run(result, wall, c, BITGCF_PATH)
    assert len(hist) == EPOCHS and hist[-1]["loss"] < hist[0]["loss"], hist
    steps = c["gather_dot_backward"] // 2  # one K1 call per domain per step
    passes = sum("valid_seconds" in h for h in hist) + 1  # the validations and the test
    want = {"graph_layer_forward": B8_PER_PROPAGATION * (steps + passes),
            "graph_layer_backward": B8_PER_PROPAGATION * steps}
    print(f"{steps} training steps, {passes} evaluation passes: B8 launches "
          f"{ {k: c[k] for k in want} }, expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)

    print("== phase 6: NATR path, run_recbole_cdr(model='NATR') on the card: SOURCE then "
          "TARGET, GAUC among the metrics", flush=True)
    del result
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="NATR", config_dict=natr_config(), saved=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["natr"] = c = ops.launch_counts()
    hist = _report_run(result, wall, c, NATR_PATH)
    check_natr_run(result, hist, c)

    print("== phase 7: DTCDR paths, run_recbole_cdr(model='DTCDR') on the card: NeuMF and DMF, "
          "full-sort, candidate and labeled evaluation", flush=True)
    del result
    torch.cuda.empty_cache()
    run_dtcdr_paths(counts)

    print("== phase 8: mapping paths, run_recbole_cdr(model='DCDCSR' | 'EMCDR' | 'SSCDR') on "
          "the card: pairwise and OVERLAP streams, the host batch path, B12", flush=True)
    torch.cuda.empty_cache()
    run_mapping_paths(counts, records)

    replaces = {
        "gather_dot_forward": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                               "recbole_cdr_tpu/models/cmf.py:45"),
        "gather_dot_backward": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                                "recbole_cdr_tpu/models/cmf.py:45"),
        "neg_sampler": ("recbole_cdr_tpu_torch/csrc/neg_sampler.cu",
                        "recbole_cdr_tpu/trainer/device_loop.py:205"),
        "swap_or_not": ("recbole_cdr_tpu_torch/csrc/shuffle.cu",
                        "recbole_cdr_tpu/trainer/device_loop.py:63"),
        "masked_topk": ("recbole_cdr_tpu_torch/csrc/masked_topk.cu",
                        "recbole_cdr_tpu/evaluator/evaluator.py:40"),
        "streaming_topk": ("recbole_cdr_tpu_torch/csrc/streaming_topk.cu",
                           "recbole_cdr_tpu/ops/topk.py:150"),
        "sparse_adam": ("recbole_cdr_tpu_torch/csrc/sparse_adam.cu",
                        "recbole_cdr_tpu/trainer/trainer.py:274"),
        "graph_layer_forward": ("recbole_cdr_tpu_torch/csrc/graph_layer.cu",
                                "recbole_cdr_tpu/models/bitgcf.py:116"),
        "graph_layer_backward": ("recbole_cdr_tpu_torch/csrc/graph_layer.cu",
                                 "recbole_cdr_tpu/models/bitgcf.py:116"),
        "rank_sum": ("recbole_cdr_tpu_torch/csrc/rank_sum.cu",
                     "recbole_cdr_tpu/evaluator/evaluator.py:63"),
        "natr_attention_forward": ("recbole_cdr_tpu_torch/csrc/natr_attention.cu",
                                   "recbole_cdr_tpu/models/natr.py:101"),
        "natr_attention_backward": ("recbole_cdr_tpu_torch/csrc/natr_attention.cu",
                                    "recbole_cdr_tpu/models/natr.py:101"),
        "natr_anchor_table": ("recbole_cdr_tpu_torch/csrc/natr_attention.cu",
                              "recbole_cdr_tpu/models/natr.py:101"),
        "natr_pair_grid": ("recbole_cdr_tpu_torch/csrc/natr_attention.cu",
                           "recbole_cdr_tpu/models/natr.py:101"),
        "rating_vector_forward": ("recbole_cdr_tpu_torch/csrc/rating_vector.cu",
                                  "recbole_cdr_tpu/models/dtcdr.py:127"),
        "rating_vector_backward": ("recbole_cdr_tpu_torch/csrc/rating_vector.cu",
                                   "recbole_cdr_tpu/models/dtcdr.py:127"),
        "candidate_topk": ("recbole_cdr_tpu_torch/csrc/masked_topk.cu",
                           "recbole_cdr_tpu/evaluator/evaluator.py:88"),
        "rank_sum_candidates": ("recbole_cdr_tpu_torch/csrc/rank_sum.cu",
                                "recbole_cdr_tpu/evaluator/evaluator.py:661"),
        "benchmark_topk": ("recbole_cdr_tpu_torch/csrc/benchmark_topk.cu",
                           "recbole_cdr_tpu/models/dcdcsr.py:179"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1],
         "launches": sum(c[name] for c in counts.values()),
         "launches_by_path": {path: c[name] for path, c in counts.items()},
         **records[name]}
        for name in ops.WRAPPERS
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_natr_run(result, hist, c):
    """Phase 6's checks: the phases and their falling losses, GAUC, and the
    launches of K1, B9, K4 and B7 against the steps, validations and tiles
    of the run."""
    model = result["model"]
    phases = [h["phase"] for h in hist]
    assert phases == ["SOURCE"] * NATR_EPOCHS[0] + ["TARGET"] * NATR_EPOCHS[1], phases
    for phase in ("SOURCE", "TARGET"):
        losses = [h["loss"] for h in hist if h["phase"] == phase]
        assert losses[-1] < losses[0], (phase, losses)
    for res in (result["test_result"], result["best_valid_result"]):
        assert 0 < res["gauc"] < 1, res
    steps = {}
    for phase in ("SOURCE", "TARGET"):
        examples = sum(h["train_examples"] for h in hist if h["phase"] == phase)
        assert examples % BATCH == 0  # 4,096 positives + 4,096 negatives per step
        steps[phase] = examples // BATCH

    def user_batch(users, item_num):  # FullSortEvalBatches.user_batch
        return max(1, min(32, users), config_dict()["eval_batch_size"] // item_num)

    n_target = model.target_num_items
    n_source = model.total_num_items - model.target_num_items + model.overlapped_num_items
    source_tiles = sum(-(-h["valid_users"] // max(user_batch(h["valid_users"], n_source),
                                                   min(2048, h["valid_users"])))
                       for h in hist if h["phase"] == "SOURCE")
    target_tiles = sum(-(-h["valid_users"] // user_batch(h["valid_users"], n_target))
                       for h in hist if h["phase"] == "TARGET")
    test_tiles = -(-result["test_users"] // user_batch(result["test_users"], n_target))
    target_passes = sum("valid_seconds" in h for h in hist if h["phase"] == "TARGET") + 1
    want = {"gather_dot_forward": steps["SOURCE"], "gather_dot_backward": steps["SOURCE"],
            "natr_attention_forward": steps["TARGET"],
            "natr_attention_backward": steps["TARGET"],
            "natr_anchor_table": target_passes,  # new parameters each pass, the test's loaded
            "natr_pair_grid": target_tiles + test_tiles,
            "masked_topk": source_tiles + target_tiles + test_tiles,
            "rank_sum": source_tiles + target_tiles + test_tiles}
    print(f"{steps} training steps; evaluation tiles: SOURCE validations {source_tiles}, "
          f"TARGET validations {target_tiles}, test {test_tiles} ({result['test_users']} "
          f"users); launches "
          f"{ {k: c[k] for k in want} }, expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)
    assert all(math.isfinite(v) for v in result["test_result"].values())


def run_dtcdr_paths(counts):
    """Phase 7: the DTCDR runs of ``DTCDR_RUNS``, each checked; their launch
    counts go into ``counts`` under the run's name."""
    import torch

    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    tests = {}
    for name, base, mode, epochs in DTCDR_RUNS:
        print(f"-- {name}: {base}, BOTH:{epochs}, eval mode {mode}", flush=True)
        cfg = dtcdr_config(base, mode, epochs)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_recbole_cdr(model="DTCDR", config_dict=cfg, saved=True)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = c = ops.launch_counts()
        hist = _report_run(result, wall, c, DTCDR_PATHS[name])
        check_dtcdr_run(mode, cfg, result, hist, c)
        tests[name] = result["test_result"]
        del result
    # ~100x fewer candidates than full-sort
    assert tests["dtcdr_uniform"]["hit@10"] > tests["dtcdr_dmf"]["hit@10"], tests


def check_dtcdr_run(mode, cfg, result, hist, c):
    """Phase 7's checks of one DTCDR run: its falling loss, the metrics'
    ranges, and the launches of B11 against the steps and evaluation passes
    and of the evaluation kernels against the tiles or candidate batches of
    every pass."""
    import numpy as np

    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.utils import init_seed

    assert [h["phase"] for h in hist] == ["BOTH"] * len(hist) and len(hist) > 1, hist
    assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
    examples = sum(h["train_examples"] for h in hist)
    assert examples % (2 * BATCH) == 0  # 2 domains x (4,096 positives + 4,096 negatives)
    steps = examples // (2 * BATCH)
    n_valid = sum("valid_seconds" in h for h in hist)
    passes = n_valid + 1  # the validations and the test
    want = {}
    if cfg["base_model"] == "DMF":
        want = {"rating_vector_forward": B11_PER_STEP * (steps + passes),
                "rating_vector_backward": B11_PER_STEP * steps}
    if mode == "full":
        n_target = result["model"].target_num_items

        def tiles(users):  # the predict fallback's tiles: FullSortEvalBatches.user_batch
            return -(-users // max(1, min(32, users), cfg["eval_batch_size"] // n_target))

        n_tiles = sum(tiles(h["valid_users"]) for h in hist if "valid_seconds" in h)
        n_tiles += tiles(result["test_users"])
        want.update(masked_topk=n_tiles, rank_sum=n_tiles)
    elif mode.startswith("uniform"):
        config = CDRConfig(model="DTCDR", config_dict=cfg, _cli_args=[])
        init_seed(config["seed"], True)
        _, valid_data, test_data = data_preparation(config, create_dataset(config))
        assert len(valid_data.uid_list) == hist[0]["valid_users"]
        batches = n_valid * len(valid_data) + len(test_data)
        want.update(candidate_topk=batches, rank_sum_candidates=batches)
        print(f"candidate lists of {valid_data.max_cand} slots, {valid_data.user_batch} users "
              "per batch", flush=True)
    res = result["test_result"]
    if mode == "labeled":
        assert sorted(res) == sorted(m.lower() for m in DTCDR_LABELED_METRICS), res
        assert 0.0 <= res["auc"] <= 1.0 and res["rmse"] >= res["mae"] >= 0.0, res
        assert np.isfinite(res["logloss"]), res
    else:
        for r in (res, result["best_valid_result"]):
            assert 0 < r["gauc"] < 1, r
    print(f"{steps} training steps, {passes} evaluation passes; launches "
          f"{ {k: c[k] for k in want} }, expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)


def dense_tiles(users, item_num):
    """The dense evaluator's tiles of a pass over ``users`` users
    (``FullSortEvaluator._dense_budget`` for a full-sort form)."""
    user_batch = max(1, min(32, users), config_dict()["eval_batch_size"] // item_num)
    return -(-users // max(user_batch, min(2048, users, (1 << 29) // item_num)))


def run_mapping_paths(counts, records):
    """Phase 8: the runs of ``MAPPING_RUNS``, each checked, their launch
    counts kept in ``counts`` under the run's name; then B12 held against its
    plain version on the DCDCSR run's tables at BOTH entry and timed into
    ``records``."""
    import torch

    import recbole_cdr_tpu_torch.models.dcdcsr as dcdcsr_module
    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    captured = []
    real = dcdcsr_module.benchmark_topk

    def capture(*args):  # the wrapper itself counts the launch
        captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    dcdcsr_module.benchmark_topk = capture
    try:
        for name, model, schedule in MAPPING_RUNS:
            print(f"-- {name}: {model}, {', '.join(schedule)}, {MAPPING_EPOCHS} epochs each",
                  flush=True)
            cfg = mapping_config(model, schedule)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = run_recbole_cdr(model=model, config_dict=cfg, saved=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[name] = c = ops.launch_counts()
            hist = _report_run(result, wall, c, MAPPING_PATHS[name])
            check_mapping_run(model, schedule, result, hist, c)
            del result
            torch.cuda.empty_cache()
    finally:
        dcdcsr_module.benchmark_topk = real
    assert len(captured) == 1, len(captured)
    check_b12(captured[0], records)


def check_mapping_run(model, schedule, result, hist, c):
    """Phase 8's checks of one run: the schedule, a falling loss within every
    phase, validation in every phase but DCDCSR's BOTH, and the launches of
    K1-K4 and B12 against the run's steps, epochs and evaluation tiles."""
    from recbole_cdr_tpu_torch.trainer.device_loop import SEGMENT_BYTES

    E = MAPPING_EPOCHS
    assert [h["phase"] for h in hist] == [p for p in schedule for _ in range(E)], hist
    for i, phase in enumerate(schedule):
        losses = [h["loss"] for h in hist[i * E:(i + 1) * E]]
        assert losses[-1] < losses[0], (phase, losses)
    validated = [not (model == "DCDCSR" and h["phase"] == "BOTH") for h in hist]
    assert ["valid_seconds" in h for h in hist] == validated, hist
    m = result["model"]
    n_source = m.total_num_items - m.target_num_items + m.overlapped_num_items
    tiles = sum(dense_tiles(h["valid_users"], n_source if h["phase"] == "SOURCE"
                            else m.target_num_items) for h in hist if "valid_seconds" in h)
    tiles += dense_tiles(result["test_users"], m.target_num_items)
    dot_steps = neg_launches = shuffle_launches = 0
    for h in hist:
        if m.needs_host_augment(h["phase"]):
            continue  # the host batch path samples on the host: no K2, K3
        # examples per step: BATCH in the pairwise and pointwise (4,096
        # positives + 4,096 negatives) streams, overlap_batch_size in OVERLAP
        ex = MAPPING_WIDTHS[model]["overlap_batch_size"] if h["phase"] == "OVERLAP" else BATCH
        assert h["train_examples"] % ex == 0, h
        steps = h["train_examples"] // ex
        segments = -(-steps // max(1, min(steps, SEGMENT_BYTES // (ex * 16))))
        shuffle_launches += segments
        if h["phase"] != "OVERLAP":
            neg_launches += segments
            dot_steps += steps
    want = {"masked_topk": tiles, "neg_sampler": neg_launches,
            "swap_or_not": shuffle_launches,
            "benchmark_topk": int(model == "DCDCSR")}
    if model != "SSCDR":
        want.update(gather_dot_forward=dot_steps, gather_dot_backward=dot_steps)
    print(f"{dot_steps} steps on the domain streams, {tiles} evaluation tiles; launches "
          f"{ {k: c[k] for k in want} }, expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)


def check_b12(args, records):
    """Hold B12 against its plain version on ``args``, the DCDCSR run's own
    tables at BOTH entry, and time it, its plain version and the library
    route (matmul, ``torch.topk``, gather, blend) into ``records``."""
    import torch

    from recbole_cdr_tpu_torch.ops import benchmark_topk as b12

    rest, src, s_pop, t_pop, k = args
    M, D = rest.shape
    n_ov = src.shape[0]
    out, idx, sim = b12.benchmark_topk(*args)
    p_out, p_idx, p_sim = b12.benchmark_topk_plain(*args)
    zero = (rest == 0).all(1)
    assert (idx[zero] == torch.arange(k, device=rest.device)).all(), "tie rule"
    top = torch.topk(rest.double() @ src.double().T, min(k + 1, n_ov), 1).values
    clear = zero | (top[:, k - 1] - top[:, k] > B12_GAP if n_ov > k
                    else torch.ones_like(zero))
    assert torch.equal(idx[clear].sort(1).values, p_idx[clear].sort(1).values), "B12 ids"
    atol, rtol = B12_TOL
    torch.testing.assert_close(sim, p_sim, atol=atol, rtol=rtol)
    torch.testing.assert_close(out[clear], p_out[clear], atol=atol, rtol=rtol, equal_nan=True)
    diff = (out[clear] - p_out[clear]).abs()
    err = float(diff[torch.isfinite(diff)].max()) if diff.numel() else 0.0
    print(f"B12 at BOTH entry: [{M}, {D}] rows against [{n_ov}, {D}], k {k}; "
          f"{int(zero.sum())} all-zero rows, {int(clear.sum())} rows clear of a near tie "
          f"at the k-th, {int(torch.isnan(out).any(1).sum())} NaN rows (sn + t_pop = 0)",
          flush=True)

    def library():
        sims = torch.matmul(rest, src.T)
        top_s, top_i = torch.topk(sims, k, 1)
        sn = s_pop[top_i].mean(1)
        beta = sn / (sn + t_pop)
        sum_sim = top_s.sum(1)
        sum_sim = torch.where(sum_sim > 0, sum_sim, torch.ones_like(sum_sim))
        sim_e = torch.einsum("mk,mkd->md", top_s, src[top_i]) / sum_sim[:, None]
        return (1 - beta)[:, None] * rest + beta[:, None] * sim_e

    flops = 2 * M * n_ov * D
    n_bytes = 4 * (M * D + n_ov * D + n_ov + M) + 4 * M * D + 8 * M * k
    make_recorder(records)("benchmark_topk", lambda: b12.benchmark_topk(*args),
                           lambda: b12.benchmark_topk_plain(*args), err, n_bytes, flops,
                           library_fn=library)
    # beside the CUDA-core bound: the same product in 3xTF32 on the tensor
    # cores, the form B5 computes its scores in
    records["benchmark_topk"]["tf32_bound_ms"] = (
        TF32_PRODUCTS_PER_SCORE * flops / PEAK_TF32_OPS_PER_S * 1e3)


def _report_run(result, wall, counts, path):
    """Print a run's per-epoch numbers, metrics and launch counts; check that
    exactly the kernels of ``path`` launched and that the metrics and losses
    are finite. Returns the run's history."""
    import numpy as np

    hist = result["history"]
    for h in hist:
        valid = (f"  valid {h['valid_seconds']:.4f} s for {h['valid_users']} users "
                 f"({h['valid_users'] / h['valid_seconds']:.1f} users/s)"
                 if "valid_seconds" in h else "  no validation")
        print(f"{h['phase']} epoch {h['epoch']}: loss {h['loss']:.6f}  train "
              f"{h['train_seconds']:.4f} s "
              f"({h['train_examples'] / h['train_seconds']:.1f} examples/s){valid}",
              flush=True)
    print(f"valid: {result['best_valid_result']}", flush=True)
    print(f"test: {result['test_result']}", flush=True)
    print(f"path wall {wall:.2f} s", flush=True)
    print("kernels " + json.dumps(counts), flush=True)
    missing = [k for k in path if counts[k] <= 0]
    assert not missing, f"kernels never launched on this path: {missing}"
    stray = [k for k, v in counts.items() if k not in path and v != 0]
    assert not stray, f"kernels of another path launched on this one: {stray}"
    metrics = list(result["test_result"].values()) + list(result["best_valid_result"].values())
    assert metrics and all(math.isfinite(v) for v in metrics), result
    assert np.isfinite([h["loss"] for h in hist]).all()
    return hist


if __name__ == "__main__":
    sys.exit(main())
