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
   K3 (B3, ``swap_or_not``) is one launch a stream (the slots, their
   permutation and the gathers of the rows' users and items), held bit for
   bit against its plain version and timed at one dense-path epoch's source
   stream (cycling), target stream and EMCDR's OVERLAP stream; its bound
   charges the integer-pipe instructions of one round, counted in the built
   kernel's SASS (``b3_round_ops``), at ``PEAK_INT32_OPS_PER_S``; B14's merge
   is held bit for bit against its plain version on sorted, tie-heavy,
   padded lists (``check_b14_merge``);
   B5 and B6 are held and timed at the catalog path's shapes (phase 4):
   B5's ids exactly on integer-valued factors, its scores within
   ``B5_TOL`` on normal ones; B6, over ``B6_STEPS`` steps of random normal
   gradients, each grouped by the plan (``group_rows``) on one kept
   scratch, bit-equal run to run and within ``B6_TOL`` of its plain version
   on CPU copies and of ``torch.optim.SparseAdam``; K1's backward (both
   forms) bit-equal to its plain version on CPU copies and run to run; the
   plan equal to its plain version, timed at B6's step and at K1's dense
   step; the row-sharded lookup's backward (``row_sum``) bit-equal to its
   plain version at a dense step's user ids over half the user table;
3. dense path: ``run_recbole_cdr(model="CMF")`` on the card, BOTH:3 with
   validation every epoch, on a synthetic pair of the benchmark's shape
   (source 30k users / 8k items / 600k interactions, target 12k / 5k / 250k,
   2k shared items, generated with numpy from a fixed seed into
   ``build/smoke_data``); K1-K4 must each launch and the plan once per K1
   backward, B5 and B6 never, the metrics be finite and the loss fall from
   epoch 0 to 2; then the run again with the same seed (``check_repeats``):
   the trained parameters ``torch.equal``, every epoch's loss and every
   metric equal (K1 sums in a fixed order);
4. catalog path: ``run_recbole_cdr(model="CMF")`` with ``phase_optimizer:
   sparse``, BOTH:2 with validation every epoch, on a synthetic catalog pair
   (source 100k users / 300k items / 2M interactions, target 60k / 1.1M /
   2.4M, 20k shared items, every item in at least one interaction, per-user
   degree capped at 400, generated into ``build/smoke_catalog``): the target
   item space exceeds the default ``streaming_topk_threshold`` of 1e6, so
   every validation and the test pass stream through B5, and training steps
   through B6, each call after its plan, K1 on the step's sub-tables by
   position (no plan). K1-K3, B5 and B6 must each launch, K4 never; no table
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
   TARGET step; the plan once per K1 backward and once per B9 forward (the
   step's anchor ids); B9's anchor table once per TARGET evaluation pass
   (each validation sees new parameters, the test pass the reloaded best
   ones) and its pair grid once per user tile of every TARGET validation and
   of the test pass (the predict fallback's tiles of ``user_batch`` rows); K4
   and B7 once per tile of every validation and of the test pass; B5, B6 and
   B8 never; the loss falls within each phase, every metric is finite and
   GAUC lies in (0, 1); then the run again with the same seed
   (``check_repeats``): the trained parameters ``torch.equal``, every
   epoch's loss and every metric equal (K1 and B9 sum in a fixed order);
7. DTCDR paths: ``run_recbole_cdr(model="DTCDR")`` on the card at DTCDR's
   published width (``properties/model/DTCDR.yaml``: embedding 64,
   ``mlp_hidden_size`` [32, 16], dropout 0.1, alpha 0.5) on the dense path's
   pair, four runs: (a) NeuMF, BOTH:3, full-sort through the predict
   fallback with GAUC: K2, K3, K4 and B7 launch, B11 never; (b) DMF, BOTH:3,
   the same: B11 forward and backward exactly 4 times per training step
   (one launch per linear table over both domains' pairs), the forward 4
   more per evaluation pass (the tower tables, once per parameter version:
   3 validations + 1 test), B11's plan twice per step and pass (the users'
   and the items' ids), K4 and B7 once per fallback tile; (c) DMF,
   BOTH:2, eval mode ``uniform 100``: B10 and B7's candidate form exactly
   once per candidate batch of every pass, K4 and B7's full-sort form
   never, and a test hit@10 above (b)'s; (d) DMF, BOTH:2, eval mode
   ``labeled`` (``threshold`` rating >= 4, AUC, MAE, RMSE, LogLoss): no
   evaluation kernel, AUC in [0, 1], RMSE >= MAE >= 0, LogLoss finite; (d)
   runs a second time with the same seed (its added seconds printed): the
   trained parameters ``torch.equal``, every epoch's loss and every metric
   equal. In every run B5, B6, B8 and B9 never launch, the loss falls and
   the metrics are finite;
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
9. mixed precision and popularity negatives: (a) the catalog path of phase
   4 under ``compute_dtype`` and ``eval_score_dtype`` bfloat16: K1's bf16
   form exactly once forward and once backward per step, B6 twice per step,
   B13 (``streaming_topk_bf16``) once per streaming tile of every
   validation and the test pass, B5 and K1's float32 form never, the
   parameters float32, the peak allocation under phase 4's limit, and the
   test Recall@10 printed beside phase 4's, and the run repeated with the
   same seed as phase 3's is (bit-equal parameters, equal losses and
   metrics); (b) CMF on the dense pair with
   popularity training negatives and adagrad (``ADAGRAD_LR``), BOTH:3;
   (c) EMCDR's BPR form at its published width with popularity negatives
   and rmsprop (``RMSPROP_LR``), SOURCE, TARGET, OVERLAP, 2 epochs each. In
   (b) and (c) B2a (``neg_sampler_popularity``) launches exactly once per
   epoch and stream and K2 never, every phase's loss drops by more than
   ``LEARN_LOSS_DROP`` and the test Recall@10 reaches
   ``LEARN_RECALL_OVER_RANDOM`` times a random ranking's, which a learner
   that does not move the weights fails; (b) prints the first step's
   gradient RMS and the target negatives' frequency of the 10 most popular
   items beside their popularity shares. In every run the metrics are
   finite. Then K1-bf16, and K1 on the same operands in float32, are held
   against their plain versions on (a)'s first sparse step (its gathered
   sub-tables, read by position), and every B2a call of (b) and (c)
   exactly against its plain version; these kernels' top-level records are
   timed there (the largest B2a call), their phase-2 records kept under
   ``shapes``;
10. mesh, in a child process (so that no process group outlives it): (a)
   B14 (``sharded_topk_local`` on every shard at its offset, then
   ``sharded_topk_merge``) at phase 4's streaming tile (B 2,048, D 64,
   I 1,100,001, k 10) for ``B14_SHARDS`` shards, the last padded with rows
   that would win if they competed: on integer-valued factors ids and scores
   exactly equal to one B5 call over the whole table and to the plain
   version; on normal ones within ``B5_TOL`` of the plain version, ids
   equal wherever neighbours are clear of a near tie; once in bf16 against
   B13 (exactly on integer-valued factors); each stage timed at one shard
   and at the main path's width (one shard: the whole table), and an empty
   kernel (``torch.cuda._sleep(0)``) timed the same way as the launch
   floor beside the merge's records; (b) the
   catalog path through ``run_recbole_cdr(model="CMF")`` with dense Adam,
   BOTH:2, over a one-rank NCCL mesh (``mesh_shape`` 1 x 1, ``distributed``
   on ``tcp://127.0.0.1:<free port>``): B14's local stage and merge exactly
   once per validation and test tile, K1-K3 launch, B5, B6 and K4 never,
   the process group gone afterwards, the loss falls, and every test metric
   equal to the same run without the mesh; (c) the dense pair's host batch path under
   the same mesh, BOTH:2, dense evaluation (K1, K4): the loss falls, the
   metrics are finite;
11. CLFM, DeepAPF and CoNet: ``run_recbole_cdr`` on the card for each at
   its published width (``properties/model/<model>.yaml``: CLFM user 64,
   item 64, shared 32; DeepAPF 64; CoNet 64 with ``mlp_hidden_size`` [64,
   32, 16, 8]) on the dense path's pair (overlapping on items), BOTH:2 with
   validation every epoch: K2 and K3 twice per epoch, K4 once per
   evaluation tile; DeepAPF's B16 (``deepapf_forward`` /
   ``deepapf_backward``, from the five tables and the step's ids) exactly
   once each per training step, the plan of the step's keys (``group_rows``)
   once per step, and its grid (``deepapf_grid``) once per tile of the
   predict fallback; CoNet's B15
   (``conet_tower``) once per dense tile, and what each of its validation
   passes allocates beyond what the run holds as it starts less than
   ``CONET_VALID_HEADROOM`` (the pass's peak above parameters and moments
   printed beside it); no other kernel; the loss falls and the
   metrics are finite;
12. BiTGCF, NATR and DTCDR's DMF under ``compute_dtype: bfloat16``, each
   with the configuration of its float32 run (phases 5, 6 and 7b), epochs
   unchanged: every kernel of the float32 run launches exactly as often,
   in its 16-bit form where it has one (K1-bf16; the 16-bit forms of B8, B9
   and B11, ``*_bf16``) and as itself otherwise (K2-K4, B7); the float32
   B8, B9 and B11 never; every phase's loss falls; the test Recall@10 within
   ``PHASE12_RECALL_TOL`` of the float32 run's (both printed);
13. DeepAPF and CoNet under ``compute_dtype: bfloat16`` with phase 11's
   configurations: every kernel of the float32 run launches exactly as
   often, B16 and B15 in their 16-bit forms (``deepapf_*_bf16``,
   ``conet_tower_bf16``), K2-K4 as themselves; the float32 B15 and B16
   never; the loss falls; the test Recall@10 within ``PHASE12_RECALL_TOL``
   of the float32 run's trained model evaluated under bf16, and of the
   float32 run's own wherever the bf16 run's own probabilities resolve a
   ranking (``run_phase13_paths``); B16-bf16's grid on the bf16 DeepAPF's
   trained model against its plain version, on its own tables and on
   tables scaled until the probabilities spread (``deepapf_trained_grid``);
   CoNet's validation passes' own
   allocations printed beside phase 11's and held to the same
   ``CONET_VALID_HEADROOM``;
14. the sparse optimizer, 16-bit compute and the mapping models under the
   mesh, in phase 10's child after 10c: (b) phase 9a's configuration (the
   bf16 catalog, ``phase_optimizer: sparse``) over a one-rank NCCL mesh,
   BOTH:2: exactly ``MESH_BF16_CATALOG_PATH`` launches, K1-bf16 once each
   per step, B6 (its row-shard form at offset 0) once per table and step
   (1,928) after its plan, B14 once per streaming tile; the loss falls,
   every epoch's loss equals phase 9a's and the test Recall@10 is within
   ``MESH_RECALL_TOL``; (a) B6's
   row-shard form on the item table's first step of (b) (its global
   occurrences and gradient rows as the run gathered them) for
   ``B6_SHARDS`` shards of ceil(N / m) rows, the last padded: on every
   shard bit-equal run to run and within ``B6_TOL`` of the plain version on
   CPU copies, the plan equal to its plain version, the padding untouched;
   the update and the plan each timed at the last shard (a nonzero offset
   and the pad rows), the update's library
   yardstick ``torch.optim.SparseAdam.step`` on the shard's own
   occurrences, and ``Mesh.gather_occurrences`` at that step's shape on
   the host clock (a one-rank group: its collectives and the host's wait
   for the lengths); (c) phase 8's DCDCSR and EMCDR runs over the same
   mesh: phase 8's launch checks (``check_mapping_run``), B12 once, and
   every test metric within ``MESH_MAPPING_TOL`` of phase 8's run, every
   epoch's loss equal to phase 8's;
15. report: the card's name and power limit, one JSON line of per-kernel
   numbers (launches per path), and the final ``{"ok": true, ...}`` line.

B8 (``graph_layer_forward`` / ``graph_layer_backward``) is held in phase 2
at the bench pair's source graph (about 50,400 rows and 441,000 nonzeros,
D = 64, dropout 0.3 from random bits): within ``B8_TOL`` of its plain
version, and two kernel runs bit-equal (a gather with no float atomic: its
rows of several blocks are finished by their last block from the blocks'
partials in block order). Its bytes bound charges the unique bytes (CSR, x,
bits, the other dense operands, the outputs), not the nnz x D row gathers,
which hit the L2 (x is 12.9 MB of its 50 MB). ``python3
probe_graph_layer.py [--parent DIR]`` splits its time by kernel and times
variants of its source and schedule at the same graph.

B2 (``neg_sampler``) is held in phase 2 exactly (``torch.equal``) against
its plain version on a source-stream epoch of the dense pair, with the
stream's live history lengths (``DomainDeviceData.lens``), as B2a is below;
their bounds (``sampler_work``) charge each slot's rounds up to its first
clean one, each drawn and compared with the user's live entries, and the
lines print H, the slots' mean and largest live lengths and that compare
count.

B7 (``rank_sum``) is held in phase 2 on the dense path's first validation
tile ([2,048, 5,001]) with integer-valued scores (ties everywhere) and with
the unit-scale scores K4 sees, a row without positives, a positive inside
its row's history and one on the PAD column: equal to its plain version and
to JAX's method (a row sort and two searchsorted, the library yardstick),
and two kernel runs equal; its launch plan (``ops/rank_sum.py::
rank_sum_plan``: one block a row on that dense tile, a row over a
thread-block cluster on the fallback tile and the candidate batches) is
printed beside each of its records. B9 (``natr_attention_forward`` /
``natr_attention_backward``: the anchor table, the pairs' anchor ids and
queries; one anchor stage per distinct anchor, from the plan of the ids) is
held at a TARGET step's shapes (8,192 pairs over about 2,100 repeated
anchors, H = 50, D = 64) in both overlap modes (user anchors with their
item histories, item anchors with their user histories), empty-history
anchors included, within ``B9_TOL`` of its plain version (the table's
gradient 0 on every row no pair names), and two kernel runs bit-equal, each
backward from its forward's kept values on the table's one kept plan; the
device time of each of their kernels is printed (``natr_split``); its
full-sort form (``natr_full_sort``: the anchor table, then
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

Phase 2 holds this slice's kernels too: K1's bf16 form forward and
backward at the dense step's pairs (the forward within ``K1_BF16_TOL``, the
backward bit-equal to its plain version on CPU copies; its library
yardstick is one ``index_add_`` per table, as for B1's); B13 on phase 4's
streaming tile cast to bf16 (scores within ``B13_TOL``, ids equal wherever
neighbouring scores differ by more; bound: one bf16 tensor-core product a
score; library: B5's route on the exactly upcast operands); B2a exactly,
at a catalog source-stream epoch (one slot per source interaction, the
stream's history matrix and live lengths, the alias table of its items).
B2a's bound (``b2a_work``) charges bytes: the two bit streams, the uids and
the output, each distinct user's live history entries and the alias table,
once each, and one draw's operations per slot.

Phase 2 also reads the SASS of the built libraries (``check_sass``,
``cuobjdump --dump-sass``): every instantiation of B13's tile kernel must
hold HGMMA (wgmma), UTMALDG (TMA loads) and SYNCS (mbarriers) and at most
the one block barrier before its roles split, K4's kernel (B10's too) and
B7's the cluster barriers (UCGABAR) of their short-tile forms, and every
instantiation of B16's grid, forward and backward pair kernels its
tensor-core products (HMMA), and every one of B15's its products (HMMA, or
HGMMA where the published tower runs on wgmma); it prints the counts, and
fails where the library of B11, K1, B6, the plan, B9, B8 or B16
(``FIXED_ORDER_SOURCES``) holds a float atomic.
B13's time is printed beside B5's from the same run, with its launch plan
and the item bytes the plan reads from L2 into the SMs (modelled from the
plan, not read from a counter), and beside the time of the same call on
factors whose scores fall with the item id, so that after a range's first
tile no score reaches a row's threshold: the products and the pipeline
without the selection's exact tests and merges. K4's launch plans (the dense
and the fallback tile) and B10's are printed, with K4's time on the fallback
tile's first 128 columns (one warp a row, one merge, no cluster): the floor
of a launch of that kernel. The plans and probes are printed on lines of
their own and kept out of the ``kernels`` records.

B11 (``rating_vector_forward`` / ``rating_vector_backward``) is held in
phase 2 at a DMF training step's shapes (16,384 ids, both domains' pairs)
on each of its four histories, the source item side (every id's history of
source users, N ~ 27.8k) timed, on that side's longest row (over 100 pieces)
at every other id of the batch, and at the tower tables' shape (every
target item), within ``B11_TOL`` of its plain version, the error of each
element against the sum of its terms' absolute values; a second run of the
forward and of the backward ``torch.equal`` to the first, in both forms
(B11 has no float atomic: ``check_sass`` fails on one in its library). The
ids' grouping (``group_rows`` on a ``RowPlan`` over the history's rows) is
held equal to its plain version on each ids tensor, and a DMF step's one
launch for both sides (users and items on their two plans) is timed on the
device and per call on the host; the forward and backward are timed from
one grouping. Their bound charges the
distinct rows' work: each distinct id's history entries and the table rows
they name read once, the ids, the output and one add per entry and
column. B10 (``candidate_topk``) and B7's
candidate form (``rank_sum_candidates``) are held exactly at the shape of
phase 7c's candidate batches ([users per batch, max positives x 101]) with
integer-valued (ties everywhere) and normal scores; the candidate form takes
each positive's column from its index (no positions tensor).

B16 (``deepapf_forward`` / ``deepapf_backward`` / ``deepapf_grid``) is
held in phase 2 at a training step's 16,384 pairs of both domains (from
the five tables and the pairs' ids, the source pairs first) and on a
fallback tile ([32 users, every target item]), at D 32, 64 and 128, with
the items and, on the same ids, the users as the entity, entity ids equal
to the overlapped count and one above it among the pairs of both domains:
within ``B16_TOL`` of its plain version (the five tables' gradients and
the weights'), the masked entities' share rows exactly 0, every table's
gradient and the rest bit-equal from run to run; timed at the main path's
(D 64, items), the backward with its plan. Its library yardstick is the
same function in torch: ``F.embedding`` gathers, the chain on cuBLAS with
both attention branches in one product, and autograd into the tables. The
pair kernels' bound is the rows the step names, each read once, the ids,
the logits (and the whole tables' gradients, written once), their products
in 3xTF32 on the tensor cores. The grid's bound is its products in 3xTF32 on the tensor cores
(the form the kernel runs, ``mma.sync``) and the rest on the CUDA cores;
the bound with every operation on the CUDA cores (the earlier pair
kernels' form) is printed beside it, with the grid's tile
(``probe_deepapf_grid.py`` splits the grid's time). B15 (``conet_tower``)
is held at the published tower, at D 32 with [32, 16] and at D 20 with
[40, 24, 10] (widths the wrapper pads to the kernel's tile unit), for 1, 32
and 2,048 users against every target item (4,980, not a multiple of the
16-item tile), within ``B15_TOL`` of its plain version per probability,
bit-equal from run to run, a call whose every logit exceeds 17 equal to it
(all 1.0), and K4's ids on the dense tile's probabilities equal wherever
neighbours are clear of the tolerance; timed at the dense tile, its bound
the products in 3xTF32 on the tensor cores (the form the kernel runs) and
the rest on the CUDA cores (the bound with every operation on the CUDA
cores is printed beside it), its library yardstick the torch chain over
the whole [2,048, 4,980, 64] hidden (JAX's form).

Phase 2 holds the 16-bit forms of B8, B9 and B11 on the same operands as
their float32 forms, rounded to bf16, against their plain versions: B8-bf16
at the source graph (``B8_BF16_TOL``, two runs bit-equal; library route
``torch.sparse.mm`` on a bf16 CSR where torch takes one), B9-bf16's training
forward and backward and full-sort form in both overlap modes, its anchor
table over every target user and its pair grid on the fallback tile
(``B9_BF16_TOL``, reruns bit-equal; library route the torch chain in bf16,
``library_natr_*``, which the float32 B9 rows are now timed against too),
B11-bf16 on the four histories of a DMF step and the longest row (forward
within ``B11_TOL``, backward within ``B11_BF16_TOL``, reruns bit-equal;
library routes ``embedding_bag`` on the bf16 table and ``index_add_`` then
one rounding). Their bounds charge
the 16-bit operands' two bytes.

Phase 2 holds the 16-bit forms of B16 and B15 the same way, at the main
path's shapes, in bfloat16 (the record) and float16 (the record's
``shapes``): B16-bf16's forward and backward on the training step's pairs
within ``B16_BF16_TOL``, the masked entities' share rows exactly 0 (in
bfloat16 also at D 32 and 128 and with the users the entity); the
16-bit probabilities of B16-bf16's grid on the fallback tile (D 64, items
the entity, the tables doubled so that they spread) and of B15-bf16 at the
dense tile by ``close_prob16``: each within a few steps of its plain
version's, at most ``PROB16_SHARE`` of them apart at all, and two controls
(a constant 0.5, and the float32 form rounded only at its output) must fail
that check; reruns bit-equal. Their bounds are the float32 forms' bytes on
2-byte operands and their operations, the matrix products at the card's
16-bit tensor rate and the rest on the CUDA cores; their library routes the
same torch chains in 16 bits (for B15 JAX's whole-hidden form on a [2,048,
4,980, 64] 16-bit hidden, 1.3 GB).

``python3 chip_smoke.py --profile [tag ...]`` instead times one warm training epoch
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
(the OVERLAP stream), SSCDR's OVERLAP (the host path); and phase 9's
paths: CMF's BOTH with popularity negatives and adagrad, EMCDR's BPR SOURCE
phase with popularity negatives and rmsprop, and the catalog path in bf16,
last; phase 11's three models and phase 12's and 13's bf16 runs (BiTGCF's BOTH,
NATR's SOURCE and TARGET, DMF's BOTH, DeepAPF's and CoNet's BOTH) come
before phase 9's paths. Given tags, it traces only the paths whose output
prefix starts with one of them (``natr_target``, ``deepapf``; ``dense``
for the dense path). Each
16-bit run also prints the per-call parameter cast apart from the kernels
(``report_casts``): the wrapped calls of its epoch and validation pass, the
device time of one cast of every floating parameter and buffer, and their
product.

Nothing here imports jax or the JAX package.
"""

import json
import math
import os
import re
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
DENSE_PATH = ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
              "swap_or_not", "masked_topk")
CATALOG_PATH = ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
                "swap_or_not", "streaming_topk", "sparse_adam")
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
                  "rating_vector_forward", "rating_vector_backward", "group_rows"),
    "dtcdr_uniform": ("neg_sampler", "swap_or_not", "candidate_topk", "rank_sum_candidates",
                      "rating_vector_forward", "rating_vector_backward", "group_rows"),
    "dtcdr_labeled": ("neg_sampler", "swap_or_not", "rating_vector_forward",
                      "rating_vector_backward", "group_rows"),
}
#: the DTCDR run that phase 7 repeats with the same seed: DMF trains and
#: evaluates bit for bit the same (B11 sums in a fixed order)
DTCDR_REPEATED = "dtcdr_labeled"
#: B11 launches per DMF training step (forward and backward) and per
#: evaluation pass (forward): one per linear table
B11_PER_STEP = 4
#: ``group_rows`` launches per DMF training step and evaluation pass: one
#: for both sides' ids (users and items on the model's two ``RowPlan``s),
#: read by both tables of a side and the backward
B11_PLANS_PER_STEP = 1

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
    "dcdcsr": ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
               "swap_or_not", "masked_topk", "benchmark_topk"),
    "emcdr": ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
              "swap_or_not", "masked_topk"),
    "sscdr": ("neg_sampler", "swap_or_not", "masked_topk"),
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the float32 rate of
#: the CUDA cores, used as the rate of the kernels' 32-bit scalar operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
#: the rate of 32-bit integer instructions on the SMs' integer pipe: the
#: Hopper white paper's 64 INT32 lanes an SM (half its 128 FP32 lanes) at the
#: boost clock behind the data sheet's float32 rate (67e12 = 132 SMs x 128
#: lanes x 2 flops an FMA x 1.98 GHz), one operation an instruction. B3's
#: bound charges its round's integer-pipe instructions (``b3_round_ops``) at it
PEAK_INT32_OPS_PER_S = PEAK_SCALAR_OPS_PER_S / 4
#: and the dense TF32 tensor-core rate: B5 scores in 3xTF32, three TF32
#: products (2 D flops each) per float32 score
PEAK_TF32_OPS_PER_S = 495e12
TF32_PRODUCTS_PER_SCORE = 3
#: the dense bf16 tensor-core rate: B13 scores in one bf16 product
PEAK_BF16_OPS_PER_S = 989e12

#: phase 9's paths: (a) the catalog path in bf16, (b) CMF on the dense pair
#: with popularity negatives and adagrad, (c) EMCDR BPR with popularity
#: negatives and rmsprop
BF16_CATALOG_PATH = ("gather_dot_forward_bf16", "gather_dot_backward_bf16", "group_rows",
                     "neg_sampler", "swap_or_not", "streaming_topk_bf16", "sparse_adam")
POPULARITY_CMF_PATH = ("gather_dot_forward", "gather_dot_backward", "group_rows",
                       "neg_sampler_popularity", "swap_or_not", "masked_topk")
POPULARITY_EMCDR_PATH = POPULARITY_CMF_PATH
POPULARITY_EMCDR_SCHEDULE = ("SOURCE", "TARGET", "OVERLAP")

#: phase 10's paths: (b) the catalog pair over a one-rank NCCL mesh, dense
#: Adam, B14 in place of B5; (c) the dense pair's host batch path under the
#: same mesh, dense evaluation
MESH_CATALOG_PATH = ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
                     "swap_or_not", "sharded_topk_local", "sharded_topk_merge")
MESH_HOST_PATH = ("gather_dot_forward", "gather_dot_backward", "group_rows", "masked_topk")
#: the model-axis widths at which phase 10a holds B14 against B5; one shard
#: is the main path's (10b's one-rank mesh), whose numbers lead its records
B14_SHARDS = (1, 2, 4)
#: phase 4's streaming tile: users, embedding width, items, k
B14_TILE = (2048, 64, 1_100_001, 10)
#: phase 10b's epochs: the second shows the mesh's cost once its NCCL
#: communicators exist
MESH_EPOCHS = 2

#: phase 14's paths: (b) phase 9a's bf16 sparse catalog over the one-rank
#: mesh, B14's 16-bit local stage in place of B13; (c) the mapping models
#: over it, phase 8's kernels
MESH_BF16_CATALOG_PATH = ("gather_dot_forward_bf16", "gather_dot_backward_bf16", "group_rows",
                          "neg_sampler", "swap_or_not", "sharded_topk_local",
                          "sharded_topk_merge", "sparse_adam")
#: the model-axis widths at which phase 14a holds B6's row-shard form
B6_SHARDS = (1, 2, 4)
#: 14b's test Recall@10 against phase 9a's (the same training on one rank;
#: B14's 16-bit local stage returns B13's ids)
MESH_RECALL_TOL = 0.002
#: 14c's test metrics against phase 8's runs
MESH_MAPPING_TOL = 0.02

#: K1 tolerance, |kernel - plain| <= ATOL + RTOL * max|plain|: the forward
#: sums the D products in another order than torch; the backward adds each
#: row's terms in position order with no contraction, as the plain version's
#: index_add_ does on the CPU, so it must equal that bit for bit
K1_TOL = {"forward": (1e-4, 1e-5), "backward": (0.0, 0.0)}

#: B5 score tolerance on normal factors, (atol, rtol): the kernel's fixed
#: d-order FMA chain and torch.matmul add the 64 products in different
#: orders; ids must agree wherever neighbouring scores differ by more
B5_TOL = (1e-4, 1e-5)

#: B6 tolerance on p, mu and nu after ``B6_STEPS`` steps, |got - ref| <=
#: ATOL * max|ref| + RTOL * |ref| per tensor. Against its plain version run
#: on CPU copies: none, the kernel must equal it bit for bit (each row's
#: gradient rows added in position order, as index_add_ adds them there,
#: then the same correctly rounded operations). Against
#: ``torch.optim.SparseAdam`` the second pair: it folds the bias corrections
#: in float64 and updates the moments as old + (1-b)(g-old)
B6_TOL = {"plain": (0.0, 0.0), "torch.optim.SparseAdam": (1e-6, 1e-5)}
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
#: a row in a fixed order of its own (row groups of a warp, pieces of 64
#: entries added in piece order), index_add_ in its own order, and two
#: float32 sums of the same terms in any two orders differ by a small
#: multiple of 2^-24 times that sum (RTOL is 64 of them)
B11_TOL = (1e-6, 2 ** -18)


#: B12 tolerance on a benchmark row, |kernel - plain| <= ATOL + RTOL * |plain|,
#: where the row's k-th and (k+1)-th similarity differ by more than
#: ``B12_GAP`` (nearer ties may order differently: the kernel adds a
#: similarity's D products in d order, cuBLAS in its own); ids equal there
#: as sets, and position by position on all-zero rows (every similarity 0)
B12_TOL = (1e-5, 1e-5)
B12_GAP = 1e-5

#: B13 score tolerance, |kernel - plain| <= ATOL + RTOL * the sum of the
#: absolute values of a score's D products: both sides multiply bf16 values
#: exactly in float32 and sum in float32 in other orders (the tensor cores
#: may cut rather than round each add); D <= 64 adds of at most 2^-23 each
#: bound the difference by 2^-17 of that sum, RTOL doubles it. Ids must agree
#: wherever neighbouring scores differ by more
B13_TOL = (1e-6, 2 ** -16)

#: K1-bf16 tolerance: scores within one bf16 ulp of the plain version's plus
#: ``RTOL`` of the sum of the products' magnitudes (both sum in float32 and
#: round once); gradients within ``K1_TOL["backward"]``: each row's float32
#: sum in position order, rounded once to bf16, as the plain version's
K1_BF16_TOL = {"forward": 2 ** -18}


#: one step of a 16-bit value v is at most 2^-7 |v| in bf16; the 16-bit forms
#: of B8, B9 and B11 and their plain versions sum in float32 in other orders
#: and round once where JAX's value is 16-bit, so a rounded value may land
#: one step apart from the plain version's and carry that step on
BF16_STEP = 2 ** -7
BF16 = "bfloat16"

#: B8-bf16 tolerance per element: side within one step of the plain
#: version's plus 2^-16 of the sum of its terms' magnitudes (float32 sums in
#: another order); new within two steps of what it adds, |new| + |side| (1 +
#: |x|), over keep; gx within one step plus 2^-16 of its product's terms
B8_BF16_TOL = {"side": (BF16_STEP, 2 ** -16), "new": 2 * BF16_STEP,
               "gx": (BF16_STEP, 2 ** -16)}

#: B9-bf16 tolerance per output tensor, |kernel - plain| <= ATOL + RTOL *
#: max|plain|: both round h, the scores, the softmax, su, the gates, beta,
#: zu and the logit (the grid's sigmoid) from float32 sums in other orders
#: (cuBLAS for the plain transfer), so an intermediate may land a step apart;
#: four steps of the tensor's largest value, plus B9_TOL's absolute term
#: (db_ua is 0 in exact arithmetic: a sum of rounding noise)
B9_BF16_TOL = (1e-5, 4 * BF16_STEP)

#: B11-bf16 tolerance: the forward's float32 sums as B11_TOL; the backward's
#: float32 sums (within B11_TOL of each other) rounded once, so within one
#: step of the plain version's plus twice B11's relative term
B11_BF16_TOL = (1e-6, 2 ** -17, BF16_STEP)

#: B16 tolerance per output tensor, |kernel - plain| <= ATOL + RTOL *
#: max|plain| (B9's form): the kernel sums x @ W's D products, the attention
#: logit's D terms and the predict dot in other orders than cuBLAS and torch
#: (forward; the grid's probabilities); the weight gradients are sums over
#: every pair, which the kernel adds per block and then block by block,
#: autograd in its own order (backward)
B16_TOL = {"forward": (1e-5, 1e-4), "grid": (1e-6, 1e-4), "backward": (1e-5, 1e-3)}
#: the widths phase 2 holds B16 at; the main path's, 64, is timed
B16_WIDTHS = (32, 64, 128)
#: B16's backward outputs: the five tables' gradients, then the weights'
B16_GRADS = ("d_share", "d_only_src", "d_only_tgt", "d_other_src", "d_other_tgt", "dW", "db",
             "dw2", "dpl")
#: B16-bf16 tolerance per output tensor (B9_BF16_TOL's form): both round x,
#: z, the a's, alpha, entity_e and the logit (the grid's sigmoid) from
#: float32 sums in other orders, so an intermediate may land a step apart
B16_BF16_TOL = (1e-5, 4 * 2 ** -7)

#: B15 tolerance per probability, |kernel - plain| <= ATOL + RTOL * A, with A
#: the logit's absolute chain (``b15_scale``: the tower on |hu| + |hi|, |W|,
#: |b|, no relu): each side rounds every layer's sums of at most 65 terms in
#: float32, at most 65 * 2^-24 of their magnitudes, and the kernel's 3xTF32
#: products drop at most about 2^-21 of each |a b| (the lo x lo term and
#: TF32's cut of lo), carried through the later layers' |W| into A; four
#: layers, two sides, and the sigmoid's slope of at most 1/4 keep the
#: difference under 2^-17 A; RTOL doubles it
B15_TOL = (1e-6, 2 ** -16)
#: the towers phase 2 holds B15 at, (D, mlp_hidden_size): the published one
#: (the main path's, timed at the dense tile), a narrower one, and one whose
#: widths the wrapper pads to the kernel's tile unit (48, 32, 16)
B15_TOWERS = ((64, [64, 32, 16, 8]), (32, [32, 16]), (20, [40, 24, 10]))
#: the user counts of a call: one user, a fallback tile's, a dense tile's
B15_USERS = (1, 32, 2048)
#: a 16-bit probability p of B15-bf16 or of B16-bf16's grid against its
#: plain version (``close_prob16``): |kernel - plain| <= EPS (2 |p| + 4 p (1 -
#: p) |z|) + EPS TINY, with EPS and TINY the type's and z the logit of p.
#: Both sides round the same named values from float32 sums in other orders,
#: so a value lands a step apart only where its float32 sum lies within the
#: sums' order error of a rounding point: two to four steps of p, four steps
#: of the logit through the sigmoid's slope p (1 - p), and the smallest
#: subnormal step. At most ``PROB16_SHARE`` of the probabilities may differ
#: at all: with float64 sums in place of float32 ones, 0.02% did on the CPU
#: (``_b15_case`` and phase 2's grid operands at the main path's shapes),
#: and 9% to 12% for the float32 forms rounded only at their output, which
#: stay within the per-value bound
PROB16_SHARE = 0.01
#: the factor phase 2's B16 tables are scaled by for B16-bf16's grid, so that
#: its probabilities spread over about (0.03, 0.97)
GRID16_SCALE = 2.0
#: the RMS phase 13 scales each table of the trained DeepAPF to for its grid
#: check, so that its probabilities spread as phase 2's doubled tables'
GRID16_RMS = 0.6

#: phase 11's runs: (name, model, published widths, ``properties/model/
#: <model>.yaml``), BOTH:``PHASE11_EPOCHS`` each, cut from the published 300
PHASE11_EPOCHS = 2
PHASE11_RUNS = (
    ("clfm", "CLFM", {"user_embedding_size": 64, "source_item_embedding_size": 64,
                      "target_item_embedding_size": 64, "share_embedding_size": 32,
                      "alpha": 0.5, "reg_weight": 1e-4}),
    ("deepapf", "DeepAPF", {"embedding_size": 64}),
    ("conet", "CoNet", {"embedding_size": 64, "reg_weight": 1e-2,
                        "mlp_hidden_size": [64, 32, 16, 8]}),
)
PHASE11_PATHS = {
    "clfm": ("neg_sampler", "swap_or_not", "masked_topk"),
    "deepapf": ("neg_sampler", "swap_or_not", "masked_topk", "deepapf_forward",
                "deepapf_backward", "group_rows", "deepapf_grid"),
    "conet": ("neg_sampler", "swap_or_not", "masked_topk", "conet_tower"),
}
#: CoNet's device memory a validation pass may allocate beyond what the run
#: holds as it starts; JAX's form of one dense tile's first hidden alone is
#: 2.6 GB
CONET_VALID_HEADROOM = 256 * 2 ** 20


#: phase 12's runs: (name, model, the float32 run of phases 5-7 whose
#: configuration it repeats with ``compute_dtype: bfloat16``, epochs
#: unchanged)
PHASE12_RUNS = (("bitgcf_bf16", "BiTGCF", "bitgcf"), ("natr_bf16", "NATR", "natr"),
                ("dmf_bf16", "DTCDR", "dtcdr_dmf"))
#: the float32 kernels whose 16-bit forms the bf16 runs launch in their place
BF16_FORMS = {k: k + "_bf16" for k in (
    "gather_dot_forward", "gather_dot_backward", "graph_layer_forward", "graph_layer_backward",
    "natr_attention_forward", "natr_attention_backward", "natr_anchor_table", "natr_pair_grid",
    "rating_vector_forward", "rating_vector_backward", "conet_tower", "deepapf_forward",
    "deepapf_backward", "deepapf_grid")}
#: phase 13's runs: (name, model, the phase-11 run whose configuration it
#: repeats with ``compute_dtype: bfloat16``)
PHASE13_RUNS = (("deepapf_bf16", "DeepAPF", "deepapf"), ("conet_bf16", "CoNet", "conet"))
#: a bf16 run's test Recall@10 within max(ABS, REL x) of its float32 run's
#: (``results/parity_oracle.md``'s tolerance)
PHASE12_RECALL_TOL = (0.02, 0.20)

#: traces ``device_ms`` takes of a function that waits on the device before it
#: fails: a torch.profiler trace now and then records no device
#: activity at all
PROFILER_TRACES = 3

#: cycles of the spin kernel that holds the stream while the host queues
#: the calls it times (about 0.1 s at the H100's clock)
SPIN_CYCLES = 200_000_000

#: prefix of the line on which the kernel-check child reports its records
_RECORDS = "KERNEL_RECORDS "
#: prefix of the line on which the mesh child reports its records and counts
_MESH = "MESH_RESULTS "


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


def phase12_config(ref):
    """A phase-12 run: the configuration of the float32 run ``ref`` (phase
    5, 6 or 7b) with ``compute_dtype: bfloat16``."""
    cfg = {"bitgcf": bitgcf_config, "natr": natr_config,
           "dtcdr_dmf": lambda: dtcdr_config(*DTCDR_RUNS[1][1:])}[ref]()
    return {**cfg, "compute_dtype": BF16}


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


def phase11_config(model):
    """A phase-11 run: the dense path's pair at ``model``'s published width,
    BOTH:``PHASE11_EPOCHS`` with validation every epoch."""
    widths = next(w for _, m, w in PHASE11_RUNS if m == model)
    return {**config_dict(), **widths, "train_epochs": [f"BOTH:{PHASE11_EPOCHS}"]}


def phase13_config(model):
    """A phase-13 run: ``model``'s phase-11 configuration under
    ``compute_dtype: bfloat16``."""
    return {**phase11_config(model), "compute_dtype": BF16}


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
    for _ in range(PROFILER_TRACES):  # a trace can come back without any device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
    assert events, f"the profiler recorded no device activity in {PROFILER_TRACES} traces"
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


def bound(n_bytes, n_ops, tf32_ops=0, bf16_ops=0, int_ops=0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak, ``n_ops`` 32-bit scalar
    operations on the CUDA cores plus ``tf32_ops`` and ``bf16_ops`` on the
    tensor cores and ``int_ops`` instructions on the integer pipe."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_ops / PEAK_SCALAR_OPS_PER_S + tf32_ops / PEAK_TF32_OPS_PER_S
             + bf16_ops / PEAK_BF16_OPS_PER_S + int_ops / PEAK_INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_recorder(out):
    """``record(name, kernel_fn, plain_fn, equal, n_bytes, n_ops, ...)``:
    times a kernel, its plain version and its library call and keeps the
    record under ``out[name]``."""

    def record(name, kernel_fn, plain_fn, equal, n_bytes, n_ops, library_fn=None, reps=20,
               shape=None, tf32_ops=0, bf16_ops=0, int_ops=0):
        """Time a kernel, its plain version and its library call; with
        ``shape``, as a second shape of an already recorded kernel, kept
        under the record's ``shapes``."""
        b_ms, b_by = bound(n_bytes, n_ops, tf32_ops, bf16_ops, int_ops)
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


#: SASS opcodes the redesigned kernels must hold (``check_sass``): every
#: instantiation of B13's tile kernel its warpgroup products (HGMMA) and
#: mbarrier operations (SYNCS), the TMA ones their TMA loads (UTMALDG), and
#: at most the one block barrier before its roles split; every instantiation
#: of K4's kernel (B10's too) and of B7's the cluster barriers of their
#: short-tile forms (UCGABAR); every instantiation of B16's grid, forward
#: and backward pair kernels its tensor-core products (HMMA: 3xTF32 in
#: float32, bf16 / f16 in 16 bits, TF32 in the backward);
#: every instantiation of B15's its tensor-core products (HMMA on mma.sync,
#: HGMMA on wgmma: the published tower's), HGMMA in one; every instantiation
#: of B12's screen its 3xTF32 products (HMMA).
#: Source -> (kernel or kernels, opcodes in every instantiation of each,
#: opcodes in at least one, opcodes counted)
SASS_OPCODES = {
    "streaming_topk": ("tile16_kernel", ("HGMMA", "SYNCS"), ("UTMALDG",),
                       ("HGMMA", "UTMALDG", "SYNCS", "BAR.SYNC")),
    "masked_topk": ("masked_topk_kernel", ("UCGABAR",), (), ("UCGABAR", "BAR.SYNC")),
    "rank_sum": ("rank_sum_kernel", ("UCGABAR",), (), ("UCGABAR", "BAR.SYNC")),
    "deepapf_attention": (("grid_kernel", "forward_kernel", "backward_kernel"), ("HMMA",), (),
                          ("HMMA", "BAR.SYNC")),
    "conet_tower": ("tower_kernel", (), ("HGMMA",), ("HMMA", "HGMMA", "BAR.SYNC")),
    "benchmark_topk": ("screen_kernel", ("HMMA",), (), ("HMMA", "BAR.SYNC")),
}
#: a float atomic in SASS (RED or ATOM on F16, BF16, F32 or F64): the
#: libraries of ``FIXED_ORDER_SOURCES`` must hold none, so that their sums
#: run in a fixed order: B11's, K1's, B6's, B9's, B8's, B16's and the
#: plan's with the row-sharded lookup's backward
FLOAT_ATOMIC = r"\b(?:RED|ATOMG?|ATOMS)\.[A-Z0-9_.]*\b(?:F16|BF16|F32|F64)"
FIXED_ORDER_SOURCES = ("rating_vector", "gather_dot", "sparse_adam", "row_groups",
                       "natr_attention", "graph_layer", "deepapf_attention")


def check_kernel_sass(source, kernel, sass, each, some, counted):
    """``check_sass`` on the instantiations of one kernel of ``source``'s
    SASS."""
    import re

    funcs = [f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0]]
    assert funcs, f"{source}: no {kernel} in the SASS"
    counts = [{op: len(re.findall(r"\b" + re.escape(op), f)) for op in counted} for f in funcs]
    total = {op: sum(c[op] for c in counts) for op in counted}
    print(f"  SASS {source}.cu {kernel} ({len(funcs)} instantiations): "
          + ", ".join(f"{op} {n}" for op, n in total.items()), flush=True)
    for op in each:
        assert all(c[op] for c in counts), f"an instantiation of {kernel} has no {op}"
    for op in some:
        assert total[op], f"no instantiation of {kernel} has {op}"
    if source == "streaming_topk":
        assert all(c["BAR.SYNC"] <= 1 for c in counts), f"{kernel} holds block barriers"
    if source == "conet_tower":
        assert all(c["HMMA"] or c["HGMMA"] for c in counts), \
            f"an instantiation of {kernel} has no tensor-core product"


def check_sass():
    """Count the opcodes of ``SASS_OPCODES`` in each instantiation of B13's,
    K4's, B7's, B16's grid and pair and B15's kernels (``cuobjdump --dump-sass`` of
    the built libraries) and fail where one is absent, where B13's selection
    holds a block barrier, or where a library of ``FIXED_ORDER_SOURCES``
    holds a float atomic."""
    import re

    from recbole_cdr_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    build.build_all()  # a run of phase 2 alone has built nothing yet
    for source, (kernels, each, some, counted) in SASS_OPCODES.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", build._lib_path(source)],
                              capture_output=True, text=True, check=True).stdout
        for kernel in (kernels,) if isinstance(kernels, str) else kernels:
            check_kernel_sass(source, kernel, sass, each, some, counted)
    for source in FIXED_ORDER_SOURCES:
        sass = subprocess.run([cuobjdump, "--dump-sass", build._lib_path(source)],
                              capture_output=True, text=True, check=True).stdout
        atomics = re.findall(FLOAT_ATOMIC, sass)
        n_all = len(re.findall(r"\b(?:RED|ATOMG?|ATOMS)\.", sass))
        print(f"  SASS {source}.cu: {len(atomics)} float atomics of {n_all} atomics",
              flush=True)
        assert not atomics, f"{source}.cu holds float atomics: {sorted(set(atomics))}"


#: SASS opcodes (their first word) that issue to the SMs' integer pipe, and
#: the integer multiply-adds, which issue to the FMA pipe
INT_PIPE_OPS = ("IADD3", "LOP3", "SHF", "IMNMX", "VIMNMX", "VIADDMNMX", "SEL", "ISETP", "LEA",
                "IABS", "PRMT", "MOV", "BMSK", "SGXT", "FLO", "POPC")
FMA_PIPE_INT_OPS = ("IMAD", "IMUL")
#: rounds of one pass of B3's round loop (``csrc/shuffle.cu``'s unroll)
B3_UNROLL = 16


def sass_loops(func):
    """Each loop of one function's SASS (``cuobjdump``'s ``/*addr*/ [@pred]
    OPCODE operands ;`` lines), as its instructions' texts from a branch's
    target to the branch, for each branch back to a lower address."""
    texts, at, loops = [], {}, []
    for line in func.splitlines():
        ins = re.search(r"/\*([0-9a-f]+)\*/\s+([^;]*);", line)
        if not ins:
            continue
        at[int(ins.group(1), 16)] = len(texts)
        texts.append(ins.group(2).strip())
        target = re.search(r"\bBRA\s+(0x[0-9a-f]+)", ins.group(2))
        if target and int(target.group(1), 16) in at:
            loops.append(texts[at[int(target.group(1), 16)]:])
    return loops


def sass_instruction(text):
    """(opcode's first word, [operands]) of one SASS instruction's text
    (``[@pred] OPCODE a, b, ...``)."""
    words = text.split(None, 2) if text.startswith("@") else [""] + text.split(None, 1)
    ops = words[2] if len(words) > 2 else ""
    return words[1].split(".")[0], [o.strip() for o in ops.split(",") if o.strip()]


def b3_round_ops():
    """(integer-pipe, integer multiply-add) SASS instructions of one
    swap-or-not round of B3's built kernel: its round loop (the loop of
    ``B3_UNROLL`` shared loads of a round's keys), less the loop's control
    (the branch, the compare that sets its predicate and the updates of the
    registers it compares), over ``B3_UNROLL`` rounds."""
    from recbole_cdr_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", build._lib_path("shuffle")],
                          capture_output=True, text=True, check=True).stdout
    func = next(f for f in sass.split("Function : ")[1:] if "stream_kernel" in f.split("\n")[0])
    body = [[sass_instruction(t) for t in lp] for lp in sass_loops(func)]
    body = [lp for lp in body if sum(op == "LDS" for op, _ in lp) == B3_UNROLL]
    assert len(body) == 1, f"B3's stream_kernel: {len(body)} loops of {B3_UNROLL} shared loads"
    body = body[0]
    branch = len(body) - 1
    setp = max(i for i, (op, _) in enumerate(body) if op == "ISETP")
    counter = {o for o in body[setp][1][2:] if re.fullmatch(r"U?R\d+", o)}
    control = {branch, setp} | {i for i, (_, args) in enumerate(body)
                                if args and args[0] in counter}
    work = [op for i, (op, _) in enumerate(body) if i not in control]
    per = [sum(op in kind for op in work) / B3_UNROLL for kind in (INT_PIPE_OPS, FMA_PIPE_INT_OPS)]
    print(f"  SASS shuffle.cu stream_kernel: its round loop holds {len(body)} instructions, "
          f"{len(control)} of them its control; a round {per[0]:g} on the integer pipe and "
          f"{per[1]:g} IMAD", flush=True)
    return per


def check_b14_merge(dev):
    """B14's merge alone on sorted lists as its local stage writes them, at
    phase 4's streaming tile (2,048 rows, k 10) and at k 64, m of
    ``B14_SHARDS`` and 8: integer scores in {-3..3} (exact ties within and
    across lists), list j's ids above list j - 1's, every third row padded
    with (-inf, INT32_MAX) after a few entries: the kernel equals its plain
    version bit for bit."""
    import torch

    from recbole_cdr_tpu_torch.ops import topk as b5

    g = torch.Generator(device=dev).manual_seed(21)
    B, span = B14_TILE[0], 1000
    for k in (B14_TILE[3], 64):
        for m in (*B14_SHARDS, 8):
            s = torch.randint(-3, 4, (m, B, k), device=dev, generator=g).float()
            ids = torch.rand(m, B, span, device=dev, generator=g).argsort(-1)[..., :k]
            ids = (ids + span * torch.arange(m, device=dev)[:, None, None]).to(torch.int32)
            order = (-s * (span * m) + ids).argsort(-1)  # (score desc, id asc)
            s, ids = s.gather(-1, order), ids.gather(-1, order)
            rows = torch.arange(B, device=dev)
            keep = torch.where(rows % 3 == 0, rows % (k + 1), k)[None, :, None]
            pad = torch.arange(k, device=dev)[None, None, :] >= keep
            s, ids = s.masked_fill(pad, -torch.inf), ids.masked_fill(pad, b5.INT32_MAX)
            got, want = b5.sharded_topk_merge(s, ids, k), b5.sharded_topk_merge_plain(s, ids, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                f"sharded_topk_merge differs from its plain version on tied lists, m={m} k={k}"
    print(f"  sharded_topk_merge on sorted tie-heavy padded lists ({B} rows, k "
          f"{B14_TILE[3]} and 64, m {(*B14_SHARDS, 8)}): equal to its plain version", flush=True)


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
    from recbole_cdr_tpu_torch.ops.masked_topk import sm_count
    from recbole_cdr_tpu_torch.ops import graph_layer as b8
    from recbole_cdr_tpu_torch.ops import neg_sampler as k2, shuffle as k3
    from recbole_cdr_tpu_torch.ops import row_groups, sparse_adam as b6, topk as b5
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    check_sass()
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

    # ---- K3 (B3): one epoch's streams, a launch each: the source (cycling),
    # the target and EMCDR's OVERLAP stream of the overlapped items ---------
    n_steps = loop.steps_per_epoch
    shuf = loop._shuffle_material(0)
    round_ops = b3_round_ops()[0]
    n_over = dataset.num_overlap_item
    over_step = MAPPING_WIDTHS["EMCDR"]["overlap_batch_size"]
    over_keys = [t.reshape(-1, k3.SHUFFLE_ROUNDS) for t in src_.shuffle_keys(0, "over", n_over)]
    streams = {
        None: (loop.src.pairs, loop.src.n, *shuf["src"], 0, n_steps,
               loop.src_step, loop.src_batches_per_cycle),
        "target": (loop.tgt.pairs, loop.tgt.n, *shuf["tgt"], 0, n_steps,
                   loop.step, 0),
        "overlap": (torch.arange(n_over, dtype=torch.int32, device=dev), n_over,
                    *over_keys, 0, -(-n_over // over_step), over_step, 0),
    }
    for shape, args in streams.items():
        got, want = k3.swap_or_not(*args), k3.swap_or_not_stream_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"swap_or_not disagrees with its plain version on the {shape or 'source'} stream"
        if shape is None:
            src_stream = got
        table, n, keys, _, _, n_st, dstep, _ = args
        T = n_st * dstep
        cols = table.shape[1] if table.dim() == 2 else 1
        record("swap_or_not", lambda args=args: k3.swap_or_not(*args),
               lambda args=args: k3.swap_or_not_stream_plain(*args), 0.0,
               T * (8 * cols + 4) + keys.numel() * 8, 0, shape=shape,
               int_ops=T * k3.SHUFFLE_ROUNDS * round_ops if n > 1 else 0)

    check_b14_merge(dev)

    # ---- K2: the source domain's negatives for one whole epoch ----------
    uid = src_stream[0].reshape(-1)
    base = torch.randint(-2 ** 31, 2 ** 31, (uid.shape[0],), dtype=torch.int32,
                         device=dev, generator=g)
    hist, ranges, lens = loop.src.hist, loop.src.cand_ranges, loop.src.lens
    a = k2.sample_negatives(base, uid, hist, ranges, 1, lens)
    b = k2.sample_negatives_plain(base, uid, hist, ranges, 1, lens=lens)
    assert torch.equal(a, b), "neg_sampler disagrees with its plain version"
    s0, l0, s1, n_cand = k2._runs(ranges)
    ranks = k2._remix(base) % n_cand
    n_bytes, n_ops = sampler_work(uid, hist, lens, 1,
                                  torch.where(ranks < l0, s0 + ranks, s1 + (ranks - l0)))
    record("neg_sampler",
           lambda: k2.sample_negatives(base, uid, hist, ranges, 1, lens),
           lambda: k2.sample_negatives_plain(base, uid, hist, ranges, 1, lens=lens),
           0.0, n_bytes, n_ops, reps=5)

    # ---- K1: one train step's pairs of both domains ---------------------
    U = torch.randn(dataset.num_total_user, config["embedding_size"], device=dev, generator=g)
    I = torch.randn(dataset.num_total_item, config["embedding_size"], device=dev, generator=g)
    xs = loop._build_xs(shuf, 0, 0, 1)
    uu = torch.cat([xs["source_user_id"][0], xs["target_user_id"][0]])
    ii = torch.cat([xs["source_item_id"][0], xs["target_item_id"][0]])
    gg = torch.randn(uu.shape[0], device=dev, generator=g)
    P, D = uu.shape[0], U.shape[1]
    check_k1(record, U, I, uu, ii, gg)
    k1_step = (U, I, uu, ii)  # its plan is timed after B6's

    # ---- K1-bf16: the same step's pairs on bf16 tables (compute_dtype) --
    check_k1(record, U.to(torch.bfloat16), I.to(torch.bfloat16), uu, ii, gg.to(torch.bfloat16))

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
    print(f"  masked_topk plan {k4.masked_topk_plan(*scores.shape, k, sm_count(dev))}",
          flush=True)

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
           rank_sum_search_ops(n_items, pmask),
           library_fn=lambda: library_rank_sum(ties, rp, items[0], pos, pmask))
    print(f"  rank_sum plan {b7.rank_sum_plan(nB, n_items, pos.shape[1], sm_count(dev))}",
          flush=True)
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
    del new, side, new2, side2, p_new, p_side, gx, p_gx, Ls, Ls_t
    b8_bf16_checks(record, csr, csr_t, x, gy, bits, keep)
    del x, gy, bits

    # ---- B9: NATR's attention at a TARGET step's and a full-sort tile's shapes
    natr_checks(dev, g, config, dataset, train_data, valid_data, record)

    # ---- B11, B10 and B7's candidate form at the DTCDR paths' shapes ----
    dtcdr_checks(dev, g, record)

    # ---- B16 and B15: DeepAPF's attention and CoNet's tower (phase 11) ---
    deepapf_conet_checks(dev, g, record, dataset, valid_data, config, uu, ii,
                         xs["source_user_id"][0].shape[0])

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

    # ---- B13: the same tile on bf16 factors (eval_score_dtype bfloat16) --
    Ub, Tb = Un.to(torch.bfloat16), Tn.to(torch.bfloat16)
    del Un, Tn
    (a_s, a_i), (b_s, b_i) = (b5.streaming_topk_bf16(Ub, Tb, rp, it, k),
                              b5.streaming_topk_bf16_plain(Ub, Tb, rp, it, k))
    absum = (Ub.float().abs()[:, None, :] * Tb.float().abs()[b_i.long()]).sum(-1)
    tol = B13_TOL[0] + B13_TOL[1] * absum
    err = float((a_s - b_s).abs().max())
    assert bool(((a_s - b_s).abs() <= tol).all()), f"streaming_topk_bf16 score error {err}"
    gap = torch.diff(b_s, dim=1).abs() > tol[:, 1:]
    clear = torch.ones_like(gap[:, :1])
    clear = torch.cat([clear, gap], 1) & torch.cat([gap, clear], 1)
    assert torch.equal(a_i[clear], b_i[clear]), "streaming_topk_bf16 ids differ where scores do not tie"
    print(f"  streaming_topk_bf16: {int(clear.sum())} of {clear.numel()} ids clear of a near "
          f"tie, all equal; max score error {err:.3g}", flush=True)
    Uu, Tu = Ub.float(), Tb.float()  # the exact upcast: the library route's operands

    def library_streaming_bf16():
        sc = Uu @ Tu.T
        sc[rows_h, it_h] = torch.finfo(torch.float32).min
        sc[:, 0] = torch.finfo(torch.float32).min
        return torch.topk(sc, k, dim=1).indices

    b13_bytes = Tb.numel() * 2 + Ub.numel() * 2 + (B + 1 + n_pairs) * 4 + B * k * 8
    record("streaming_topk_bf16",
           lambda: b5.streaming_topk_bf16(Ub, Tb, rp, it, k),
           lambda: b5.streaming_topk_bf16_plain(Ub, Tb, rp, it, k),
           err, b13_bytes, 0, library_fn=library_streaming_bf16, reps=10,
           bf16_ops=2 * B * n_items * D)
    del Uu, Tu
    plan = b5.streaming_topk_bf16_plan(B, n_items, D, k, sm_count(dev))
    print(f"  streaming_topk_bf16 beside B5 in this run: {out['streaming_topk_bf16']['ms']:.4f} "
          f"against {out['streaming_topk']['ms']:.4f} ms; plan {plan}; L2-to-SM item bytes "
          f"modelled from the plan {plan['l2_bytes'] / 1e9:.3f} GB", flush=True)
    # probe: the same call on factors whose scores fall with the item id for
    # every row (x_i = 1 - i / 2^21, exact as the sum of three bf16 terms), so
    # that no score after a range's first tile reaches a row's threshold
    x = 1.0 - torch.arange(n_items, device=dev, dtype=torch.float64) / 2.0 ** 21
    Tp = torch.zeros_like(Tb)
    for j in range(3):
        Tp[:, j] = x.to(torch.bfloat16)
        x = x - Tp[:, j].double()
    Up = torch.zeros_like(Ub)
    Up[:, :3] = 1
    assert torch.equal(b5.streaming_topk_bf16(Up, Tp, rp, it, k)[1],
                       b5.streaming_topk_bf16_plain(Up, Tp, rp, it, k)[1])
    falling_ms = device_ms(lambda: b5.streaming_topk_bf16(Up, Tp, rp, it, k), 10)[0]
    print(f"  streaming_topk_bf16 probe: scores falling with the item id {falling_ms:.4f} ms "
          f"against {out['streaming_topk_bf16']['ms']:.4f} ms on the normal factors", flush=True)
    del Ub, Tb, Up, Tp

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
    grads = [torch.randn(R, D, device=dev, generator=g) for _ in range(B6_STEPS)]
    plan = row_groups.RowPlan(N, dev, capacity=R)
    runs = [(P0.clone(), torch.zeros_like(P0), torch.zeros_like(P0)) for _ in range(2)]
    plain = (P0.cpu(), torch.zeros(N, D), torch.zeros(N, D))
    tp = torch.nn.Parameter(P0.clone())
    topt = torch.optim.SparseAdam([tp], lr=lr)
    for c, (ids, G) in enumerate(zip(step_ids, grads), 1):
        step = b6.adam_step_size(lr, 0.9, 0.999, c)
        for state in runs:  # each run groups the ids anew on the same kept plan
            b6.sparse_adam(*state, G, ids, step, groups=row_groups.group_rows(ids, plan))
        b6.sparse_adam_plain(*plain, G.cpu(), ids.cpu(), step, 0.9, 0.999, 1e-8)
        tp.grad = torch.sparse_coo_tensor(ids.long()[None], G, (N, D))
        topt.step()
    st = topt.state[tp]
    kern = runs[0]
    err = err_torch = 0.0
    for name, got, again, want, torch_want in zip(
            ("p", "mu", "nu"), kern, runs[1], plain,
            (tp.detach(), st["exp_avg"], st["exp_avg_sq"])):
        assert torch.equal(got, again), f"sparse_adam {name} does not repeat"
        check_b6_plain(name, got, want)
        atol, rtol = B6_TOL["torch.optim.SparseAdam"]
        diff, scale = (got - torch_want).abs(), torch_want.abs()
        assert bool((diff <= atol * float(scale.max()) + rtol * scale).all()), \
            f"sparse_adam {name} against torch.optim.SparseAdam: error {float(diff.max())}"
        err = max(err, float((got.cpu() - want).abs().max()))
        err_torch = max(err_torch, float(diff.max()))
    assert not plan.scratch[0].any(), "group_rows left its counters dirty"
    print(f"  sparse_adam: {B6_STEPS} steps on random normal gradients, max_abs_err {err:.3g} "
          f"against the plain version on CPU copies, bit-equal run to run; max_abs_err "
          f"against torch.optim.SparseAdam {err_torch:.3g}", flush=True)
    ids, G = step_ids[0], grads[0]
    step = b6.adam_step_size(lr, 0.9, 0.999, 1)
    groups = row_groups.group_rows(ids, plan)
    check_plan(groups, ids, N)
    n_own, n_rows = (int(x) for x in groups.meta[:2])
    plain_dev = (P0.clone(), torch.zeros_like(P0), torch.zeros_like(P0))
    record("sparse_adam",
           lambda: b6.sparse_adam(*kern, G, ids, step, groups=groups),
           lambda: b6.sparse_adam_plain(*plain_dev, G, ids, step, 0.9, 0.999, 1e-8),
           err, 4 * n_own + G.numel() * 4 + 6 * n_rows * D * 4, n_rows * D * 12 + R * D,
           library_fn=topt.step)
    record("group_rows",
           lambda: row_groups.group_rows(ids, plan),
           lambda: row_groups.group_rows_plain(ids, N),
           0.0, *plan_work(R, n_own, n_rows), library_fn=lambda: torch.sort(ids, stable=True))
    del runs, kern, plain, plain_dev, tp, topt, P0, grads, plan

    # ---- the plan of K1's dense step (both tables' ids in one launch) ------
    Uk, Ik, uu, ii = k1_step
    P, D = uu.shape[0], Uk.shape[1]
    gu, gi = k1.backward_groups(Uk, Ik, uu, ii)  # anew: a plan's row_head holds until the next
    check_plan(gu, uu, Uk.shape[0])
    check_plan(gi, ii, Ik.shape[0])
    n_heads = int(gu.meta[1]) + int(gi.meta[1])
    record("group_rows",
           lambda: k1.backward_groups(Uk, Ik, uu, ii),
           lambda: (row_groups.group_rows_plain(uu, Uk.shape[0]),
                    row_groups.group_rows_plain(ii, Ik.shape[0])),
           0.0, *plan_work(2 * P, 2 * P, n_heads),
           library_fn=lambda: (torch.sort(uu, stable=True), torch.sort(ii, stable=True)),
           shape="K1's dense step, both tables")

    # ---- the row-sharded lookup's backward: a dense step's user rows, m = 2
    L = -(-Uk.shape[0] // 2)
    src = torch.randn(P, D, device=dev, generator=g)
    lookup = row_groups.group_rows(uu, row_groups.RowPlan(L, dev))
    got = row_groups.row_sum(src, uu, lookup)
    want = row_groups.row_sum_plain(src.cpu(), lookup, uu.cpu())
    assert torch.equal(got.cpu(), want) and torch.equal(got, row_groups.row_sum(src, uu, lookup)), \
        "row_sum differs from its plain version or between runs"
    n_own, n_rows = (int(x) for x in lookup.meta[:2])
    own = uu.long() < L
    record("row_sum", lambda: row_groups.row_sum(src, uu, lookup),
           lambda: row_groups.row_sum_plain(src, lookup, uu),
           0.0, 4 * n_own + n_own * D * 4 + L * D * 4, n_own * D,
           library_fn=lambda: torch.zeros(L, D, device=dev).index_add_(
               0, uu.long()[own], src[own]))

    # ---- B2a: popularity negatives of one epoch of the source stream ------
    popularity_checks(dev, g, ctrain, cdataset, record)
    return out


def k1_rescans(dev):
    """The count of K1 backward tables read by position whose ids broke
    the promise and were recomputed, on ``dev`` so far."""
    from recbole_cdr_tpu_torch.ops import gather_dot as k1

    return k1.positions_rescans(dev)


def check_no_rescans(dev, before, where):
    """Fail if a K1 backward of the run since ``before`` (the count of
    :func:`k1_rescans`) had to recompute a table read by position: the
    path's ids must keep the promise, or it runs many times slower."""
    after = k1_rescans(dev)
    print(f"K1 positions-form rescans in {where}: {after - before}", flush=True)
    assert after == before, f"{where}: K1 recomputed {after - before} tables read by position"


def check_k1(record, U, I, uu, ii, gg, positions=(False, False), shape=None):
    """Hold K1 on one step's tables, ids and score gradients, forward and
    backward, against its plain version, and time both directions through
    ``record`` (under ``shape`` when given): float32 tables through
    ``gather_dot_*`` (the forward within ``K1_TOL``), 16-bit ones through
    ``gather_dot_*_bf16`` (within ``K1_BF16_TOL``); the backward, in the
    forms ``positions`` asks for (``gather_dot.backward_groups``), within
    ``K1_TOL["backward"]`` of the plain version on CPU copies and bit-equal
    to a second run. Returns the backward's forms."""
    import torch

    from recbole_cdr_tpu_torch.ops import gather_dot as k1

    P, D = uu.shape[0], U.shape[1]
    wide = U.dtype == torch.float32
    fwd, bwd = ("gather_dot_forward", "gather_dot_backward") if wide else \
        ("gather_dot_forward_bf16", "gather_dot_backward_bf16")
    forward, backward = getattr(k1, fwd), getattr(k1, bwd)
    a = forward(U, I, uu, ii)
    b = k1.gather_dot_plain(U, I, uu, ii)
    assert a.dtype == U.dtype and torch.equal(a, forward(U, I, uu, ii)), f"{fwd} does not repeat"
    diff = (a.float() - b.float()).abs()
    if wide:
        atol, rtol = K1_TOL["forward"]
        ok = float(diff.max()) <= atol + rtol * float(b.abs().max())
    else:
        absum = k1.gather_dot_plain(U.float().abs(), I.float().abs(), uu, ii)
        ok = bool((diff <= torch.finfo(U.dtype).eps * b.float().abs()
                   + K1_BF16_TOL["forward"] * absum).all())
    assert ok, f"{fwd} error {float(diff.max())}"
    size = U.element_size()
    rows = size * D * (torch.unique(uu).numel() + torch.unique(ii).numel())
    record(fwd, lambda: forward(U, I, uu, ii), lambda: k1.gather_dot_plain(U, I, uu, ii),
           float(diff.max()), 8 * P + rows + size * P, 2 * P * D,
           library_fn=lambda: (U[uu] * I[ii]).sum(-1), shape=shape)
    groups = k1.backward_groups(U, I, uu, ii, positions)
    runs = [backward(U, I, uu, ii, gg, groups) for _ in range(2)]
    want = k1.gather_dot_backward_plain(*(t.cpu() for t in (U, I, uu, ii, gg)))
    atol, rtol = K1_TOL["backward"]
    err = 0.0
    for got, again, ref in zip(*runs, want):
        assert got.dtype == U.dtype and torch.equal(got, again), f"{bwd} does not repeat"
        d = float((got.cpu().float() - ref.float()).abs().max())
        assert d <= atol + rtol * float(ref.float().abs().max()), f"{bwd} error {d}"
        err = max(err, d)
    forms = ["positions" if s == k1.POSITIONS else "grouped" for s in groups]
    print(f"  K1 {U.dtype}: {P} pairs on [{U.shape[0]}, {D}] and [{I.shape[0]}, {D}] tables, "
          f"backward forms {forms}: bit-equal to the plain version on CPU copies and run to "
          "run", flush=True)
    record(bwd, lambda: backward(U, I, uu, ii, gg, groups),
           lambda: k1.gather_dot_backward_plain(U, I, uu, ii, gg),
           err, (8 + size) * P + rows + (U.numel() + I.numel()) * size, 4 * P * D,
           library_fn=lambda: library_gather_dot_backward(U, I, uu, ii, gg), shape=shape)
    return groups


def library_gather_dot_backward(U, I, u, i, g):
    """K1's backward as PyTorch calls: one ``index_add_`` of ``g * other
    row`` into each table, in the tables' type."""
    import torch

    u, i = u.long(), i.long()
    return (torch.zeros_like(U).index_add_(0, u, g[:, None] * I[i]),
            torch.zeros_like(I).index_add_(0, i, g[:, None] * U[u]))


def check_b6_plain(name, got, want):
    """B6's ``got`` (p, mu or nu on the card) against the plain version's
    ``want`` on CPU copies, within ``B6_TOL["plain"]``."""
    atol, rtol = B6_TOL["plain"]
    diff = (got.cpu() - want).abs()
    assert bool((diff <= atol * float(want.abs().max()) + rtol * want.abs()).all()), \
        f"sparse_adam {name}: error {float(diff.max())} against its plain version"


def check_plan(groups, ids, n_rows, offset=0):
    """A plan of the card (``ops/row_groups.py::group_rows``) equal to its
    plain version on CPU copies, heads in row order (the card's come in no
    set order), every head's ``row_head`` entry naming it, the same heads
    listed as big."""
    import torch

    from recbole_cdr_tpu_torch.ops import row_groups

    want = row_groups.group_rows_plain(ids.cpu(), n_rows, offset)
    assert torch.equal(groups.meta[:3].cpu(), want.meta[:3]), (groups.meta, want.meta)
    for a, b in zip(row_groups.canonical(groups), row_groups.canonical(want)):
        assert torch.equal(a, b), "group_rows differs from its plain version"
    H, n_big = int(want.meta[1]), int(want.meta[2])
    heads = groups.row_head[groups.head_row[:H].long()]
    assert torch.equal(heads.cpu(), torch.arange(H, dtype=torch.int32)), "row_head"
    big_rows = [torch.sort(g.head_row[g.big[:n_big].long()].cpu()).values for g in (groups, want)]
    assert torch.equal(*big_rows), "group_rows lists other big heads"


def plan_work(R, n_own, n_heads):
    """(bytes, operations) a plan must move and do: read R ids, write the
    own positions, and per head its row, start, length and map entry."""
    return 4 * R + 4 * n_own + 16 * n_heads + 8, 4 * R


def popularity_checks(dev, g, ctrain, cdataset, record):
    """B2a held exactly against its plain version at a catalog source-stream
    epoch's shapes: one slot per source interaction (its user, in a random
    order), the stream's full-width history matrix and the alias table of
    its training interactions' items, and timed."""
    import numpy as np
    import torch

    from recbole_cdr_tpu_torch.ops import neg_sampler as k2
    from recbole_cdr_tpu_torch.sampler.sampler import _AliasTable
    from recbole_cdr_tpu_torch.trainer.device_loop import DomainDeviceData

    table = ctrain.source_batcher.table
    data = DomainDeviceData(table, ctrain.source_batcher.sampler, cdataset.num_total_user, dev)
    at = _AliasTable(np.asarray(table[table.iid_field]))
    alias = (torch.as_tensor(np.asarray(at.values, np.int32), device=dev),
             torch.as_tensor(np.asarray(at.prob, np.float32), device=dev),
             torch.as_tensor(np.asarray(at.alias, np.int32), device=dev))
    uid = data.uid[torch.randperm(data.n, device=dev, generator=g)]
    T, H, n = uid.shape[0], data.hist.shape[1], at.values.shape[0]
    bits = lambda: torch.randint(-2 ** 31, 2 ** 31, (T,), dtype=torch.int32, device=dev,  # noqa: E731
                                 generator=g)
    base, accept = bits(), bits()
    print(f"  neg_sampler_popularity at a catalog source-stream epoch: {T} slots, history "
          f"[{data.hist.shape[0]}, {H}], alias table of {n} items", flush=True)
    out = k2.sample_negatives_popularity(base, accept, uid, data.hist, alias, 1, data.lens)
    check_b2a(record, (base, accept, uid, data.hist, alias, 1, data.lens, out))


def sampler_work(uids, hist, lens, neg_num, cand):
    """(bytes, operations) that B2's function needs for one call: the bit
    stream, the uids and the output, and each distinct user's live history
    entries, each once; per slot, its rounds up to its first clean one (all
    R when none is clean), each drawn (12 32-bit operations) and compared
    with the slot's live entries. ``cand`` [R, slots] are the slots'
    candidates. Prints H, the mean and the largest live length of the slots'
    users and the compares counted, beside the R * H a slot the padded rows
    would take."""
    import torch

    from recbole_cdr_tpu_torch.ops import neg_sampler as k2

    R, T = k2.R_ROUNDS, uids.shape[0] * neg_num
    users = uids.long().repeat(neg_num)
    slot_lens = lens[users].long()
    live = int(lens[torch.unique(uids).long()].long().sum())
    cols = torch.arange(hist.shape[1], device=hist.device)
    rounds = torch.empty(T, dtype=torch.long, device=hist.device)
    chunk = max(1, (1 << 27) // (R * hist.shape[1]))
    for lo in range(0, T, chunk):
        rows = hist[users[lo:lo + chunk]].long()
        hit = (rows[None] == cand[:, lo:lo + chunk, None]) & (cols < slot_lens[lo:lo + chunk, None])
        clean = ~hit.any(-1)
        rounds[lo:lo + chunk] = torch.where(clean.any(0), clean.to(torch.int8).argmax(0) + 1, R)
    compares = int((rounds * slot_lens).sum())
    print(f"  neg_sampler: {T} slots, H {hist.shape[1]}, live history of the slots' users "
          f"mean {float(slot_lens.float().mean()):.2f}, largest {int(slot_lens.max())}; rounds "
          f"a slot to its first clean one mean {float(rounds.float().mean()):.3f}; {compares} "
          f"compares (R * H a slot: {T * R * hist.shape[1]})", flush=True)
    return 12 * T + 4 * live, compares + int(rounds.sum()) * 12


def b2a_work(base, accept, uids, hist, alias, neg_num, lens):
    """(bytes, operations) that B2a's function needs for one call: the two
    bit streams, the uids and the output, each distinct user's live history
    entries and the alias table, each once; one draw per slot (its first
    round, about 24 32-bit operations: two murmur3 finalisers, the modulo,
    the acceptance test and the selects). The rounds a slot redraws and the
    membership tests are not charged. Prints the slots' live lengths as
    ``sampler_work`` does."""
    from recbole_cdr_tpu_torch.ops import neg_sampler as k2

    T = uids.shape[0] * neg_num
    cand = k2._alias_candidates(base, accept, alias)
    n_bytes = sampler_work(uids, hist, lens, neg_num, cand)[0]
    return n_bytes + 4 * T + 12 * alias[0].shape[0], 24 * T


def check_b2a(record, call):
    """Hold one B2a call (base, accept, uids, hist, alias, neg_num, lens,
    out) exactly against its plain version on the same inputs, and time it
    through ``record``."""
    import torch

    from recbole_cdr_tpu_torch.ops import neg_sampler as k2

    base, accept, uids, hist, alias, neg_num, lens, out = call
    want = k2.sample_negatives_plain(base, uids, hist, None, neg_num, alias, accept, lens)
    assert torch.equal(out, want), "neg_sampler_popularity disagrees with its plain version"
    if record is None:
        return
    n_bytes, n_ops = b2a_work(base, accept, uids, hist, alias, neg_num, lens)
    record("neg_sampler_popularity",
           lambda: k2.sample_negatives_popularity(base, accept, uids, hist, alias, neg_num,
                                                  lens),
           lambda: k2.sample_negatives_plain(base, uids, hist, None, neg_num, alias, accept,
                                             lens),
           0.0, n_bytes, n_ops, reps=5)


def main_path_recorder(records, where):
    """A ``record`` that keeps a kernel's record at the main path's shapes
    (``where``) as its top-level record, and the phase-2 record under its
    ``shapes``."""
    record = make_recorder(records)

    def at_main_path(name, *args, **kwargs):
        earlier = records.pop(name)
        shapes = {"phase 2": earlier, **earlier.pop("shapes", {})}
        record(name, *args, **kwargs)
        records[name].update(shapes=shapes, at=where)

    return at_main_path


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


def rank_sum_search_ops(n_cols, pmask):
    """B7's compares on its rows' data: every column of a row with valid
    positives searches the row's sorted list (a power of 2 N >= their
    count) twice, log2 N + 1 compares each."""
    ops = 0
    for n in pmask.sum(1).tolist():
        if n:
            ops += n_cols * 2 * ((int(n) - 1).bit_length() + 1)
    return ops


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


def within(got, want, tol, what):
    """max |got - want| after asserting it within the per-element tolerance
    ``tol``; prints it and the largest share of the tolerance used."""
    diff = (got.float() - want.float()).abs()
    used = float((diff / tol).max())
    assert used <= 1.0, f"{what}: error {float(diff.max())}, {used:.3g} of the tolerance"
    print(f"  {what}: max_abs_err {float(diff.max()):.3g}, {used:.3g} of the tolerance",
          flush=True)
    return float(diff.max())


def b8_bf16_checks(record, csr, csr_t, x, gy, bits, keep):
    """B8-bf16 on phase 2's source-graph layer rounded to bf16 (the table, the
    CSRs' values, the upstream gradient): within ``B8_BF16_TOL`` of its plain
    version, two runs bit-equal; timed beside its plain version and, where
    torch takes a bf16 CSR, ``torch.sparse.mm`` with the torch epilogue."""
    import torch

    from recbole_cdr_tpu_torch.ops import graph_layer as b8

    dt = getattr(torch, BF16)
    c16, ct16 = (m._replace(val=m.val.to(dt)) for m in (csr, csr_t))
    x16, g16 = x.to(dt), gy.to(dt)
    N, D, nnz = x.shape[0], x.shape[1], csr.col.shape[0]
    new, side = b8.graph_layer_forward(c16, x16, bits, keep)
    assert new.dtype == side.dtype == dt
    p_new, p_side = b8.graph_layer_forward_plain(c16, x16, bits, keep)
    absum = b8._spmm_plain(c16._replace(val=c16.val.abs()), x16.abs())
    step, rel = B8_BF16_TOL["side"]
    err = within(side, p_side, step * p_side.float().abs() + rel * absum + 1e-30,
                 "graph_layer_forward_bf16 side")
    scale = (p_new.float().abs() + (p_side.float().abs() + rel * absum)
             * (1 + x16.float().abs())) / keep
    err = max(err, within(new, p_new, B8_BF16_TOL["new"] * scale + 1e-6,
                          "graph_layer_forward_bf16 new"))
    new2, side2 = b8.graph_layer_forward(c16, x16, bits, keep)
    assert torch.equal(new, new2) and torch.equal(side, side2), \
        "graph_layer_forward_bf16 differs run to run"
    gx = b8.graph_layer_backward(ct16, x16, side, bits, keep, g16)
    p_gx = b8.graph_layer_backward_plain(ct16, x16, side, bits, keep, g16)
    gp = b8._dropped_grad(g16.float(), bits, keep)
    absum_t = b8._spmm_plain(ct16._replace(val=ct16.val.abs()), (gp + gp * x16.float()).abs())
    step, rel = B8_BF16_TOL["gx"]
    err_b = within(gx, p_gx, step * p_gx.float().abs() + rel * absum_t + 1e-6,
                   "graph_layer_backward_bf16")
    assert torch.equal(gx, b8.graph_layer_backward(ct16, x16, side, bits, keep, g16)), \
        "graph_layer_backward_bf16 differs run to run"
    mask = b8.keep_mask(bits, keep)
    library = library_t = None
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        try:
            Ls, Ls_t = (torch.sparse_csr_tensor(m.row_ptr.long(), m.col.long(), m.val, (N, N))
                        for m in (c16, ct16))
            torch.sparse.mm(Ls, x16)

            def library():
                sd = torch.sparse.mm(Ls, x16)
                return torch.where(mask, (x16 + sd + x16 * sd) / keep, 0.0), sd

            def library_t():
                gq = torch.where(mask, g16 / keep, 0.0)
                return (gq + gq * side) + torch.sparse.mm(Ls_t, gq + gq * x16)
        except (RuntimeError, NotImplementedError) as e:
            print(f"  graph_layer_*_bf16: no library route, torch.sparse.mm refuses a bf16 CSR "
                  f"({str(e).splitlines()[0][:160]})", flush=True)
    csr_bytes = 4 * (N + 1) + 6 * nnz
    record("graph_layer_forward_bf16",
           lambda: b8.graph_layer_forward(c16, x16, bits, keep),
           lambda: b8.graph_layer_forward_plain(c16, x16, bits, keep),
           err, csr_bytes + N * D * (3 * 2 + 4), 2 * nnz * D + 8 * N * D, library_fn=library)
    record("graph_layer_backward_bf16",
           lambda: b8.graph_layer_backward(ct16, x16, side, bits, keep, g16),
           lambda: b8.graph_layer_backward_plain(ct16, x16, side, bits, keep, g16),
           err_b, csr_bytes + N * D * (4 * 2 + 4), 2 * nnz * D + 12 * N * D,
           library_fn=library_t)


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


def kernel_split(fn, reps=10):
    """{kernel name: mean device ms per call of ``fn``} from a torch.profiler
    trace of ``reps`` calls (a trace can lose launches, which undercounts)."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(PROFILER_TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
    split = defaultdict(float)
    for e in events:
        m = re.search(r"\w+_kernel", e.name)
        split[m.group(0) if m else e.name[:40]] += e.time_range.elapsed_us() / reps / 1e3
    return dict(split)


def natr_split(hist, table, anchors, q, w, gz, plan):
    """Prints where B9's training forward (the plan, the transfer, the
    heads) and backward (the rows, the block-order sum) spend their device
    time, from a trace."""
    from recbole_cdr_tpu_torch.ops import natr_attention as b9

    kept = []
    for what, fn in (("forward",
                      lambda: b9.natr_attention_forward(hist, table, anchors, q, w, plan)),
                     ("backward", lambda: b9.natr_attention_backward(hist, table, anchors, q,
                                                                     w, gz, kept[0]))):
        if what == "backward":  # after the forward's calls, which group anew
            kept.append(b9._forward_call(hist, table, anchors, q, w, plan)[1])
        split = kernel_split(fn)
        print(f"  natr_attention {what} split (device ms a call): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda x: -x[1])), flush=True)


def natr_products(n_rows, D, backward=False):
    """The matrix products' share of ``natr_work`` (the transfer ``src @ W``;
    the backward's dW and dx): what a 16-bit form may run on the tensor
    cores."""
    return n_rows * 2 * D * D * (2 if backward else 1)


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
    from recbole_cdr_tpu_torch.ops.row_groups import RowPlan
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
        table = tables[own]
        pu = table[anchors.long()]
        q = tables[other][(step_items if items_mode else step_users).long()]
        print(f"  natr_attention [{mode}]: P {P}, H {hm.shape[1]}, D {D}, "
              f"{int(torch.unique(anchors).numel())} distinct anchors", flush=True)

        plan = RowPlan(table.shape[0], dev)  # the model's kept plan of the table
        a, kept = b9._forward_call(hist, table, anchors, q, w, plan)
        b = b9.natr_attention_forward_plain(hist, table, anchors, q, w)
        err_f = close(a, b, B9_TOL["forward"], f"natr_attention_forward [{mode}]")
        # the backward from the forward's kept values, as the autograd path
        # runs it; then both again: bit-equal
        ka = b9.natr_attention_backward(hist, table, anchors, q, w, gz, kept)
        pa = b9.natr_attention_backward_plain(hist, table, anchors, q, w, gz)
        names = ("dtable", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da")
        err_b = 0.0
        for name, x, y in zip(names, ka, pa):
            if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
                assert float(x.abs().max()) <= B9_TOL["backward"][0], f"db_da {float(x)}"
                continue
            err_b = max(err_b, close(x, y, B9_TOL["backward"], f"natr_attention_backward {name} [{mode}]"))
        untouched = torch.ones(table.shape[0], dtype=torch.bool, device=dev)
        untouched[anchors.long()] = False
        assert not bool(ka[0][untouched].any()), "natr_attention_backward: an untouched row"
        logits, kept = b9._forward_call(hist, table, anchors, q, w, plan)
        assert torch.equal(logits, a), "natr_attention_forward differs run to run"
        again = b9.natr_attention_backward(hist, table, anchors, q, w, gz, kept)
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
        bf16 = natr_bf16_checks(hist, table, anchors, q, w, gz, fa, fp, fq, items_mode, mode,
                                plan)
        if not items_mode:
            continue

        n_anchor = int(torch.unique(anchors).numel())
        rows = int(torch.unique(hist.ids[torch.unique(anchors).long()]).numel())
        fixed = 4 * (D * D + 3 * D + 2)
        # each distinct anchor's history, source rows and table row, each
        # pair's id, query and logit; the backward also reads g and writes
        # dq and every row of d(table)
        N = table.shape[0]
        fwd_bytes = n_anchor * H * 5 + rows * D * 4 + (n_anchor + P) * D * 4 + P * 8 + fixed
        bwd_bytes = fwd_bytes + P * 4 + (P + N) * D * 4 + fixed
        print(f"  natr_attention: {n_anchor} distinct anchors gather {rows} distinct "
              f"source rows", flush=True)
        # the forward with its plan; the backward from a forward's kept values
        # (the training step's call)
        record("natr_attention_forward",
               lambda: b9.natr_attention_forward(hist, table, anchors, q, w, plan),
               lambda: b9.natr_attention_forward_plain(hist, table, anchors, q, w),
               err_f, fwd_bytes, natr_work(rows, n_anchor * H, P, D),
               library_fn=lambda: library_natr_forward(hist, table, anchors, q, w))
        _, kept = b9._forward_call(hist, table, anchors, q, w, plan)
        record("natr_attention_backward",
               lambda: b9.natr_attention_backward(hist, table, anchors, q, w, gz, kept),
               lambda: b9.natr_attention_backward_plain(hist, table, anchors, q, w, gz),
               err_b, bwd_bytes, natr_work(rows, n_anchor * H, P, D, backward=True),
               library_fn=lambda: library_natr_backward(hist, table, anchors, q, w, gz))
        natr_split(hist, table, anchors, q, w, gz, plan)
        # the 16-bit forms on the same operands rounded to bf16: 2-byte floats
        h16, t16, a16, q16, w16, gz16 = bf16["training"]
        fixed16 = 2 * (D * D + 3 * D + 2)
        fwd16 = n_anchor * H * 5 + rows * D * 2 + (n_anchor + P) * D * 2 + P * 6 + fixed16
        bwd16 = fwd16 + P * 2 + (P + N) * D * 2 + fixed16
        record("natr_attention_forward_bf16",
               lambda: b9.natr_attention_forward(h16, t16, a16, q16, w16, plan),
               lambda: b9.natr_attention_forward_plain(h16, t16, a16, q16, w16),
               bf16["errors"]["forward"], fwd16,
               natr_work(rows, n_anchor * H, P, D) - natr_products(rows, D),
               bf16_ops=natr_products(rows, D),
               library_fn=lambda: library_natr_forward(h16, t16, a16, q16, w16))
        _, kept16 = b9._forward_call(h16, t16, a16, q16, w16, plan)
        record("natr_attention_backward_bf16",
               lambda: b9.natr_attention_backward(h16, t16, a16, q16, w16, gz16, kept16),
               lambda: b9.natr_attention_backward_plain(h16, t16, a16, q16, w16, gz16),
               bf16["errors"]["backward"], bwd16,
               natr_work(rows, n_anchor * H, P, D, backward=True)
               - natr_products(rows, D, True), bf16_ops=natr_products(rows, D, True),
               library_fn=lambda: library_natr_backward(h16, t16, a16, q16, w16, gz16))
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
               natr_work(rows_t, n_tu * H, 0, D), reps=10,
               library_fn=lambda: library_natr_anchor(hist, every, t_pu, w))
        t_pu16 = t_pu.to(t16.dtype)
        table16 = b9.natr_anchor_table(h16, every, t_pu16, w16)
        err_t16 = close16(table16, b9.anchor_plain(h16, every, t_pu16, w16), "natr_anchor_table_bf16")
        assert torch.equal(table16, b9.natr_anchor_table(h16, every, t_pu16, w16)), \
            "natr_anchor_table_bf16 differs run to run"
        record("natr_anchor_table_bf16",
               lambda: b9.natr_anchor_table(h16, every, t_pu16, w16),
               lambda: b9.anchor_plain(h16, every, t_pu16, w16),
               err_t16, n_tu * H * 5 + rows_t * D * 2 + 2 * n_tu * D * 2 + fixed16,
               natr_work(rows_t, n_tu * H, 0, D) - natr_products(rows_t, D),
               bf16_ops=natr_products(rows_t, D), reps=10,
               library_fn=lambda: library_natr_anchor(h16, every, t_pu16, w16))
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
               natr_work(0, 0, B * n_target, D), reps=50,
               library_fn=lambda: library_natr_grid(su_t, fp, fq, w))
        su16, fp16, fq16 = table16[fs_users.long()], fp.to(t16.dtype), fq.to(t16.dtype)
        g16 = b9.natr_pair_grid(su16, fp16, fq16, w16, True)
        err_g16 = close16(g16, b9.pair_grid_plain(su16, fp16, fq16, w16, True),
                          "natr_pair_grid_bf16")
        assert torch.equal(g16, b9.natr_pair_grid(su16, fp16, fq16, w16, True)), \
            "natr_pair_grid_bf16 differs run to run"
        record("natr_pair_grid_bf16",
               lambda: b9.natr_pair_grid(su16, fp16, fq16, w16, True),
               lambda: b9.pair_grid_plain(su16, fp16, fq16, w16, True),
               err_g16, (2 * B + n_target) * D * 2 + B * n_target * 2 + 2 * (D + 1),
               natr_work(0, 0, B * n_target, D), reps=50,
               library_fn=lambda: library_natr_grid(su16, fp16, fq16, w16))
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
    print(f"  masked_topk {tile} plan {k4.masked_topk_plan(*fs_probs.shape, k, k4.sm_count(dev))}",
          flush=True)
    # probe: the tile's first 128 columns, one warp a row and no cluster
    head = fs_probs[:, :128].contiguous()
    head_ms = device_ms(lambda: k4.masked_topk(head, rp, it, k), 50)[0]
    print(f"  masked_topk probe: [{B}, 128] (plan {k4.masked_topk_plan(B, 128, k, k4.sm_count(dev))}) "
          f"{head_ms:.4f} ms", flush=True)
    record("rank_sum",
           lambda: b7.rank_sum(fs_probs, rp, it, pos, pmask),
           lambda: b7.rank_sum_plain(fs_probs, rp, it, pos, pmask),
           0.0, fs_probs.numel() * 4 + rp.numel() * 4 + n_pairs * 4 + pos.numel() * 5 + B * 4,
           rank_sum_search_ops(n_target, pmask),
           library_fn=lambda: library_rank_sum(fs_probs, rp, it, pos, pmask), shape=tile)
    print(f"  rank_sum {tile} plan {b7.rank_sum_plan(B, n_target, pos.shape[1], k4.sm_count(dev))}",
          flush=True)


def close_prob16(got, want, what, controls):
    """16-bit probabilities ``got`` of a kernel against ``want``, its plain
    version's, by ``PROB16_SHARE``'s rule; each of ``controls`` (name ->
    probabilities that a wrong kernel would give) must fail the same rule.
    Returns the largest error."""
    import torch

    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    fi = torch.finfo(want.dtype)
    p = want.float()
    z = torch.nan_to_num(torch.log(p) - torch.log1p(-p), nan=0.0, posinf=0.0, neginf=0.0)
    tol = fi.eps * (2 * p + 4 * p * (1 - p) * z.abs()) + fi.eps * fi.tiny

    def rule(x):
        diff = (x.float() - p).abs()
        return diff, float((diff / tol).max()), float((diff > 0).float().mean())

    diff, used, share = rule(got)
    print(f"  {what}: max_abs_err {float(diff.max()):.3g}, {used:.3g} of the tolerance, "
          f"{share:.5f} of the probabilities differ (at most {PROB16_SHARE}); plain "
          f"probabilities in [{float(p.min()):.4g}, {float(p.max()):.4g}]", flush=True)
    assert used <= 1.0 and share <= PROB16_SHARE, f"{what}: error {float(diff.max())}"
    for name, x in controls.items():
        _, c_used, c_share = rule(x.to(want.dtype))
        print(f"    control {name}: {c_used:.3g} of the tolerance, {c_share:.5f} differ: "
              "fails, as it must", flush=True)
        assert c_used > 1.0 or c_share > PROB16_SHARE, f"{what}: control {name} passes"
    return float(diff.max())


def close16(got, want, what, dtype=BF16, tol=B9_BF16_TOL):
    """A 16-bit form of B9 (B16) against its plain version: ``B9_BF16_TOL``
    (``B16_BF16_TOL``), both of type ``dtype``."""
    import torch

    assert got.dtype == want.dtype == getattr(torch, dtype), (what, got.dtype, want.dtype)
    atol, rtol = tol
    tol = atol + rtol * float(want.float().abs().max())
    return within(got, want, torch.full_like(want, tol, dtype=torch.float32), what)


def natr_bf16_checks(hist, table, anchors, q, w, gz, fa, fp, fq, items_mode, mode, plan):
    """B9's 16-bit training forward and backward and its full-sort form on the
    operands of phase 2's float32 checks rounded to bf16, against their plain
    versions (``B9_BF16_TOL``), reruns bit-equal; ``plan``: the RowPlan of
    the table's rows. Returns the operands and the errors."""
    import torch

    from recbole_cdr_tpu_torch.ops import natr_attention as b9

    dt = getattr(torch, BF16)
    h16 = b9.History(hist.src.to(dt), hist.ids, hist.mask)
    w16 = b9.Weights(*(t.to(dt) for t in w))
    t16, q16, gz16 = table.to(dt), q.to(dt), gz.to(dt)
    a, kept = b9._forward_call(h16, t16, anchors, q16, w16, plan)
    err_f = close16(a, b9.natr_attention_forward_plain(h16, t16, anchors, q16, w16),
                    f"natr_attention_forward_bf16 [{mode}]")
    ka = b9.natr_attention_backward(h16, t16, anchors, q16, w16, gz16, kept)
    pa = b9.natr_attention_backward_plain(h16, t16, anchors, q16, w16, gz16)
    err_b = 0.0
    for name, x, y in zip(("dtable", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da"),
                          ka, pa):
        if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
            assert float(x.float().abs().max()) <= 1e-5, f"db_da {float(x)}"
            continue
        err_b = max(err_b, close16(x, y, f"natr_attention_backward_bf16 {name} [{mode}]"))
    again, kept = b9._forward_call(h16, t16, anchors, q16, w16, plan)
    assert torch.equal(a, again), "natr_attention_forward_bf16 differs run to run"
    again = b9.natr_attention_backward(h16, t16, anchors, q16, w16, gz16, kept)
    assert all(torch.equal(x, y) for x, y in zip(ka, again)), \
        "natr_attention_backward_bf16 differs run to run"
    fp16, fq16 = fp.to(dt), fq.to(dt)
    c = b9.natr_full_sort(h16, fa, fp16, fq16, w16, items_mode)
    err_s = close16(c, b9.natr_full_sort_plain(h16, fa, fp16, fq16, w16, items_mode),
                    f"natr_full_sort_bf16 [{mode}]")
    assert torch.equal(c, b9.natr_full_sort(h16, fa, fp16, fq16, w16, items_mode))
    return {"training": (h16, t16, anchors, q16, w16, gz16),
            "errors": {"forward": err_f, "backward": err_b, "full_sort": err_s}}


def library_natr_anchor(hist, anchors, pu, w):
    """B9's library yardstick, the anchor stage as a torch chain in the
    operands' type: the transfer of the [A x H] gathered rows in one cuBLAS
    product with its bias, the masked scores, softmax and weighted sum."""
    import torch

    a, H, D = anchors.long(), hist.ids.shape[1], pu.shape[1]
    he = torch.addmm(w.b, hist.src[hist.ids[a].reshape(-1).long()], w.W).view(-1, H, D)
    s = (torch.relu(pu[:, None, :] * he) @ w.w_ua).squeeze(-1) + w.b_ua
    s = s + torch.where(hist.mask[a], 0.0, -10000.0).to(s.dtype)
    return torch.bmm(torch.softmax(s, 1)[:, None, :], he).squeeze(1)


def library_natr_blend(su, pu, q, w):
    """The pair stage as a torch chain: both gates in one product, beta as a
    softmax over the two (JAX's exp(b_s) / (exp(b_s) + exp(b_p)))."""
    import torch

    gates = torch.relu(torch.stack([su * q, pu * q])) @ w.w_da + w.b_da
    beta = torch.softmax(gates, 0)[0]
    return ((beta * su + (1 - beta) * pu) * q).sum(-1)


def library_natr_forward(hist, table, anchors, q, w):
    """The chain from the anchor table: its rows gathered per pair."""
    pu = table[anchors.long()]
    return library_natr_blend(library_natr_anchor(hist, anchors, pu, w), pu, q, w)


def library_natr_backward(hist, table, anchors, q, w, g):
    """Autograd of the torch chain for the gradients B9's backward returns."""
    import torch

    from recbole_cdr_tpu_torch.ops.natr_attention import Weights

    leaves = [t.detach().requires_grad_() for t in (table, q, *w)]
    with torch.enable_grad():
        out = library_natr_forward(hist, leaves[0], anchors, leaves[1], Weights(*leaves[2:]))
        return torch.autograd.grad(out, leaves, g)


def library_natr_grid(su, pu, q, w):
    """The torch chain over a grid's pairs (anchors on the rows)."""
    import torch

    return torch.sigmoid(library_natr_blend(su[:, None, :], pu[:, None, :], q[None, :, :], w))


def host_call_ms(fn, reps=200):
    """Host milliseconds a call of ``fn`` takes to return, over ``reps``
    calls issued back to back (the device runs behind them)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def dmf_plan_line(model, users, items):
    """Print DMF's grouping of a step's ids as the model makes it: one
    ``group_rows`` launch for both sides on the model's two kept plans, held
    equal to the plain version, its device ms (queued), its host ms a call,
    its bound, and the route its ids take (the inboxes up to
    ``row_groups.INBOX_IDS`` ids a grouping, else the four rounds); then the
    same for the tower tables' ``arange``s of every target user and item."""
    import torch

    from recbole_cdr_tpu_torch.ops import row_groups

    up, ip = model._row_plans(users.device)
    nu, ni = model.target_num_users, model.target_num_items
    every = (torch.arange(nu, dtype=torch.int32, device=users.device),
             torch.arange(ni, dtype=torch.int32, device=users.device))
    for what, (a, b) in (("a DMF step", (users, items)), ("the tower tables", every)):
        def one():
            return row_groups.group_rows(a, up, second=(b, ip))
        ga, gb = one()
        check_plan(ga, a, up.L)
        check_plan(gb, b, ip.L)
        own = int(ga.meta[0]) + int(gb.meta[0])
        heads = int(ga.meta[1]) + int(gb.meta[1])
        b_ms, b_by = bound(*plan_work(a.shape[0] + b.shape[0], own, heads))
        ms, how = device_ms(one, 20)
        route = "inboxes" if max(a.shape[0], b.shape[0]) <= row_groups.INBOX_IDS else "rounds"
        print(f"  group_rows [{what}, both sides in one launch]: {a.shape[0]} + {b.shape[0]} ids "
              f"over {up.L} / {ip.L} rows, {heads} heads, route {route}; kernel {ms:.4f} ms "
              f"({how}), host {host_call_ms(one):.4f} ms a call, bound {b_ms:.4f} ms ({b_by})",
              flush=True)


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
    from recbole_cdr_tpu_torch.ops import row_groups
    from recbole_cdr_tpu_torch.ops.masked_topk import masked_topk_plan, sm_count
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

    errs = {"forward": 0.0, "backward": 0.0, "forward_bf16": 0.0, "backward_bf16": 0.0}
    dt16 = getattr(torch, BF16)
    timed = None

    def hold_b11(name, csr, N, ids, x, gout):
        """B11 and B11-bf16 on one history and one ids tensor from one
        grouping (on a plan of its own): forward and backward within
        tolerance of their plain versions, and a second run of each
        bit-equal."""
        R = csr.ptr.shape[0] - 1
        plan = row_groups.group_rows(ids, row_groups.RowPlan(R, dev))
        check_plan(plan, ids, R)
        for key, table in (("", x), ("_bf16", x.to(dt16))):
            dtype = table.dtype
            got = b11.rating_vector_forward(csr, table, ids, plan)
            errs["forward" + key] = max(errs["forward" + key], close(
                got, b11.rating_vector_plain(csr, table, ids),
                b11.rating_vector_plain(csr, table.abs(), ids),
                f"rating_vector_forward{key} [{name}]"))
            assert torch.equal(got, b11.rating_vector_forward(csr, table, ids, plan)), \
                f"rating_vector_forward{key} [{name}] differs run to run"
            dt = b11.rating_vector_backward(csr, N, ids, gout, dtype, plan)
            want = b11.rating_vector_backward_plain(csr, N, ids, gout, dtype)
            absum = b11.rating_vector_backward_plain(csr, N, ids, gout.abs())
            assert dt.dtype == dtype
            if key:
                atol, rtol, step = B11_BF16_TOL
                err = within(dt, want, atol + rtol * absum + step * want.float().abs(),
                             f"rating_vector_backward_bf16 [{name}]")
            else:
                err = close(dt, want, absum, f"rating_vector_backward [{name}]")
            errs["backward" + key] = max(errs["backward" + key], err)
            assert torch.equal(dt, b11.rating_vector_backward(csr, N, ids, gout, dtype, plan)), \
                f"rating_vector_backward{key} [{name}] differs run to run"
        print(f"  rating_vector [{name}]: both forms' forward and backward bit-equal over two "
              "runs", flush=True)
        return plan

    for name, table, ids in (("s_items", model.source_user_linear, users),
                             ("t_items", model.target_user_linear, users),
                             ("s_users", model.source_item_linear, items),
                             ("t_users", model.target_item_linear, items)):
        csr = model._csr(name)
        N = table.shape[0]
        x = 0.3 * torch.randn(N, D, device=dev, generator=g)
        gout = torch.randn(ids.shape[0], D, device=dev, generator=g)
        plan = hold_b11(name, csr, N, ids, x, gout)
        n_ids, n_entries, n_rows = b11_work(csr, ids)
        print(f"  rating_vector [{name}]: {ids.shape[0]} ids, {n_ids} distinct, "
              f"{n_entries} history entries naming {n_rows} of [{N} x {D}]'s rows", flush=True)
        if name == "s_users":
            timed = (csr, x, ids, gout, N, n_ids, n_entries, n_rows, plan)
    # the longest history row (over 100 pieces) in a batch of heavily
    # repeating ids: half the batch that row, the rest 64 other rows
    csr, x, ids, gout, N = timed[:5]
    lens = csr.ptr[1:] - csr.ptr[:-1]
    longest = int(torch.argmax(lens))
    assert int(lens[longest]) > 100 * b11.PIECE, int(lens[longest])
    heavy = torch.where(torch.arange(ids.shape[0], device=dev) % 2 == 0, longest,
                        ids[torch.arange(ids.shape[0], device=dev) % 64]).to(torch.int32)
    hold_b11(f"s_users, row {longest} of {int(lens[longest])} entries at every other id",
             csr, N, heavy, x, gout)
    # the tower tables' shape: every target item on the source user side
    every = torch.arange(model.target_num_items, dtype=torch.int32, device=dev)
    every_plan = row_groups.group_rows(every, row_groups.RowPlan(csr.ptr.shape[0] - 1, dev))
    errs["forward"] = max(errs["forward"], close(
        b11.rating_vector_forward(csr, x, every, every_plan),
        b11.rating_vector_plain(csr, x, every),
        b11.rating_vector_plain(csr, x.abs(), every), "rating_vector_forward [tower table]"))

    csr, x, ids, gout, N, n_ids, n_entries, n_rows, plan = timed
    B = ids.shape[0]
    owner, entry = b11._expand(csr, ids)
    flat = csr.cols[entry].long()
    lens = csr.ptr[ids.long() + 1] - csr.ptr[ids.long()]
    offsets = torch.cumsum(lens, 0) - lens
    vec = torch.zeros(B, N, device=dev)
    vec[owner, flat] = 1.0
    jax_ms = device_ms(lambda: vec @ x, 10)[0]
    csr_bytes = 8 * n_ids + 4 * n_entries
    dmf_plan_line(model, users, items)
    record("rating_vector_forward",
           lambda: b11.rating_vector_forward(csr, x, ids, plan),
           lambda: b11.rating_vector_plain(csr, x, ids),
           errs["forward"], n_rows * D * 4 + 4 * B + csr_bytes + B * D * 4, n_entries * D,
           library_fn=lambda: torch.nn.functional.embedding_bag(
               flat, x, offsets.long(), mode="sum"), reps=10)
    g_rows = gout[owner]
    record("rating_vector_backward",
           lambda: b11.rating_vector_backward(csr, N, ids, gout, torch.float32, plan),
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
    # the 16-bit form: 2-byte table rows and gradient, float32 sums, out and gout
    x16 = x.to(dt16)
    record("rating_vector_forward_bf16",
           lambda: b11.rating_vector_forward(csr, x16, ids, plan),
           lambda: b11.rating_vector_plain(csr, x16, ids),
           errs["forward_bf16"], n_rows * D * 2 + 4 * B + csr_bytes + B * D * 4, n_entries * D,
           library_fn=lambda: torch.nn.functional.embedding_bag(
               flat, x16, offsets.long(), mode="sum"), reps=10)
    record("rating_vector_backward_bf16",
           lambda: b11.rating_vector_backward(csr, N, ids, gout, dt16, plan),
           lambda: b11.rating_vector_backward_plain(csr, N, ids, gout, dt16),
           errs["backward_bf16"], B * D * 4 + 4 * B + csr_bytes + N * D * 2,
           n_entries * D + B * D,
           library_fn=lambda: torch.zeros(N, D, device=dev).index_add_(0, flat, g_rows).to(dt16),
           reps=10)
    print("  rating_vector_*_bf16: library yardsticks embedding_bag(mode='sum') on the bf16 "
          "table (bf16 out), and index_add_ of the float32 gradient rows then one rounding",
          flush=True)
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
    print(f"  candidate_topk plan {masked_topk_plan(B, C, k, sm_count(dev), cand=True)}",
          flush=True)
    record("rank_sum_candidates",
           lambda: b7.rank_sum_candidates(ties, cm, pm),
           lambda: b7.rank_sum_candidates_plain(ties, cm, pm),
           0.0, B * C * 6 + B * 4, rank_sum_search_ops(C, pm),
           library_fn=lambda: library_rank_sum_candidates(ties, cm, pm))
    print(f"  rank_sum_candidates plan {b7.rank_sum_plan(B, C, C, sm_count(dev), cand=True)}",
          flush=True)


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


def deepapf_work(n_pairs, D, backward=False):
    """Operations of B16 on ``n_pairs`` pairs: per pair the two attention
    products (2 x 2 D^2), their bias, relu and ``w2`` dot (2 x 3 D), the
    products x_s, x_o, the blend and the predict dot (6 D); the backward
    adds dW's and dx's products (2 x 2 x 2 D^2) and the rows' gradients
    (about 10 D)."""
    fwd = 2 * (2 * D * D + 3 * D) + 6 * D
    return n_pairs * (fwd + (8 * D * D + 10 * D if backward else 0))


def deepapf_products(n_pairs, D, backward=False):
    """The matrix products' share of ``deepapf_work`` (x @ W; the backward's
    dW and dx): what a 16-bit form may run on the tensor cores."""
    return n_pairs * (4 * D * D + (8 * D * D if backward else 0))


def conet_work(n_pairs, widths):
    """Operations of B15 on ``n_pairs`` pairs of a tower of ``widths`` (H0,
    then each later layer's): the first layer's two adds and relu and the
    sigmoid (3 H0 + 3), the later layers' products (2 d_in d_out) and the
    output dot (2 d_last)."""
    return n_pairs * (3 * widths[0] + 3) + conet_products(n_pairs, widths)


def conet_products(n_pairs, widths):
    """The matrix products' share of ``conet_work``: what a 16-bit form may
    run on the tensor cores."""
    prods = sum(a * b for a, b in zip(widths, widths[1:]))
    return n_pairs * (2 * prods + 2 * widths[-1])


def library_deepapf_chain(share, only, other, mask, w):
    """B16's logits of gathered rows in torch: the chain on cuBLAS, both
    attention branches in one product."""
    import torch

    from recbole_cdr_tpu_torch.ops.deepapf_attention import MASKED

    P = share.shape[0]
    a = torch.relu(torch.cat([share * other, only * other]) @ w.W + w.b) @ w.w2
    masked = max(MASKED, torch.finfo(a.dtype).min)  # float16 holds no -1e31
    a = torch.stack([a[:P, 0].masked_fill(mask, masked), a[P:, 0]], 1)
    alpha = torch.softmax(a, 1)
    ent = alpha[:, :1] * share + alpha[:, 1:] * only
    return ((ent * other) @ w.pl)[:, 0]


def library_deepapf(tabs, pairs, overlapped, w):
    """B16's library route: the rows by ``F.embedding`` (the shared table's
    over both domains' ids at once), then ``library_deepapf_chain``."""
    import torch
    import torch.nn.functional as F

    ent = torch.cat([pairs.ent_src, pairs.ent_tgt]).long()

    def two(src, tgt, a, b):
        return torch.cat([F.embedding(a.long(), src), F.embedding(b.long(), tgt)])

    return library_deepapf_chain(
        F.embedding(ent, tabs.share),
        two(tabs.only_src, tabs.only_tgt, pairs.ent_src, pairs.ent_tgt),
        two(tabs.other_src, tabs.other_tgt, pairs.oth_src, pairs.oth_tgt), ent > overlapped, w)


def library_deepapf_backward(tabs, pairs, overlapped, w, g):
    """The library route's gradients: autograd through ``library_deepapf``
    into the five tables and the weights."""
    import torch

    from recbole_cdr_tpu_torch.ops.deepapf_attention import Tables, Weights

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (*tabs, *w)]
        logit = library_deepapf(Tables(*leaves[:5]), pairs, overlapped, Weights(*leaves[5:]))
        return torch.autograd.grad(logit, leaves, g)


def b16_step_bytes(tabs, pairs, esize, backward=False):
    """Bytes B16's forward (backward) must move at a step: each row the
    step's ids name read once, the ids, the logits (the logits' gradient),
    the weights; the backward also writes the five tables' gradients whole
    and the weights'."""
    import torch

    D = tabs.share.shape[1]
    ent = torch.cat([pairs.ent_src, pairs.ent_tgt])
    named = sum(int(torch.unique(i).numel()) for i in
                (ent, pairs.ent_src, pairs.ent_tgt, pairs.oth_src, pairs.oth_tgt))
    P = int(ent.numel())
    fixed = esize * (D * D + 3 * D)
    out = 0 if not backward else esize * D * sum(t.shape[0] for t in tabs) + fixed
    return esize * D * named + 8 * P + esize * P + fixed + out


def library_conet(hu, hi, b0, layers, out_layer):
    """B15's library route: the torch chain on cuBLAS over the whole [B, I,
    H0] hidden at once (JAX's form)."""
    import torch

    h = torch.relu(hu[:, None, :] + hi[None, :, :] + b0)
    for W, b in layers:
        h = torch.relu(h @ W + b)
    return torch.sigmoid((h @ out_layer[0] + out_layer[1])[..., 0])


def b15_scale(hu, hi, b0, layers, out_layer, chunk=512):
    """Each probability's tolerance scale: the tower's absolute chain (|hu|
    + |hi| + |b0|, then |W| and |b| at every layer, no relu), [B, I]."""
    import torch

    parts = []
    for lo in range(0, hi.shape[0], chunk):
        h = hu.abs()[:, None, :] + hi[lo:lo + chunk].abs()[None, :, :] + b0.abs()
        for W, b in layers:
            h = h @ W.abs() + b.abs()
        parts.append((h @ out_layer[0].abs() + out_layer[1].abs())[..., 0])
    return torch.cat(parts, 1)


def deepapf_conet_checks(dev, g, record, dataset, valid_data, config, uu, ii, n_src):
    """Hold B16 (forward, backward, grid) against its plain version in both
    modes at D 32, 64 and 128, a training step's pairs (``uu``, ``ii``: both
    domains' 16,384, the first ``n_src`` the source domain's) from the five
    tables and a fallback tile, ids at and above the overlapped count among
    both domains' pairs, two runs bit-equal, and time the main path's (D 64,
    items as the entity); hold B15 at the published tower and at a
    narrower one for 1, 32 and 2,048 users against every target item, a
    saturating call included, K4's ids on its probabilities where
    neighbours are clear of the tolerance, and time the dense tile."""
    import torch

    from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator, _fused_eval_arrays
    from recbole_cdr_tpu_torch.ops import conet_tower as b15
    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16
    from recbole_cdr_tpu_torch.ops import masked_topk as k4

    nu, ni = dataset.num_total_user, dataset.num_total_item
    n_target = dataset.num_overlap_item + dataset.num_target_only_item
    n_ov = {"item": dataset.num_overlap_item, "user": nu // 4}  # the user mode: any count
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device=dev, generator=g)
    P = uu.shape[0]
    gz = torch.randn(P, device=dev, generator=g)
    fs_uids = _fused_eval_arrays(valid_data, valid_data.user_batch, dev)[0]
    fs_users = fs_uids[:valid_data.user_batch]
    grid_items = torch.arange(n_target, device=dev)

    def close(got, want, tol, what):
        atol, rtol = tol
        err = float((got - want).abs().max())
        assert err <= atol + rtol * float(want.abs().max()), f"{what}: error {err}"
        return err

    for D in B16_WIDTHS:
        w = b16.Weights(rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1), rnd(D, 1, scale=0.3),
                        rnd(D, 1, scale=0.3))
        tables = {"user": [rnd(nu, D, scale=0.3) for _ in range(3)],
                  "item": [rnd(ni, D, scale=0.3) for _ in range(3)]}
        for side in ("item", "user"):
            other_side = "user" if side == "item" else "item"
            ent, oth = (ii, uu) if side == "item" else (uu, ii)
            ent = ent.clone()  # the overlapped count and the one above it, in both domains
            ent[:4] = torch.tensor([n_ov[side], n_ov[side] + 1, n_ov[side], 0], device=dev)
            ent[n_src:n_src + 4] = torch.tensor([n_ov[side] + 1, n_ov[side], 0, n_ov[side]],
                                                device=dev)
            share_t, only_s, only_t = tables[side]
            other_t = tables[other_side][2]
            tabs = b16.Tables(share_t, only_s, only_t, tables[other_side][1], other_t)
            pairs = b16.Pairs(ent[:n_src], oth[:n_src], ent[n_src:], oth[n_src:])
            masked = torch.unique(ent[ent > n_ov[side]].long())
            named = torch.unique(ent[ent <= n_ov[side]].long())
            tag = f"D {D}, {side}s the entity"
            args = (tabs, pairs, n_ov[side], w)
            a = b16.deepapf_forward(*args)
            err_f = close(a, b16.deepapf_forward_plain(*args), B16_TOL["forward"],
                          f"deepapf_forward [{tag}]")
            assert torch.equal(a, b16.deepapf_forward(*args)), "deepapf_forward differs run to run"
            ka = b16.deepapf_backward(*args, gz)
            pa = b16.deepapf_backward_plain(*args, gz)
            err_b = 0.0
            for name, x, y in zip(B16_GRADS, ka, pa):
                err_b = max(err_b, close(x, y, B16_TOL["backward"],
                                         f"deepapf_backward {name} [{tag}]"))
            assert not bool(ka[0][masked].any()), "a masked entity's share row got a gradient"
            assert bool(ka[0][named].any())
            again = b16.deepapf_backward(*args, gz)
            assert all(torch.equal(x, y) for x, y in zip(ka, again)), \
                "deepapf_backward differs run to run"
            grid_args = (share_t, only_t, other_t, fs_users, grid_items, n_ov[side],
                         side == "item", w)
            c = b16.deepapf_grid(*grid_args)
            assert c.shape == (fs_users.shape[0], n_target)
            err_g = close(c, b16.deepapf_grid_plain(*grid_args), B16_TOL["grid"],
                          f"deepapf_grid [{tag}]")
            assert torch.equal(c, b16.deepapf_grid(*grid_args)), "deepapf_grid differs run to run"
            print(f"  deepapf_attention [{tag}]: P {P} ({n_src} source), {masked.numel()} masked "
                  f"entities; max_abs_err forward {err_f:.3g}, backward {err_b:.3g}, grid "
                  f"{err_g:.3g}", flush=True)
            if D != 64 or side != "item":  # the main path's 16-bit forms: b16_bf16_checks
                e16 = check_b16_16(args, gz, masked, BF16, f"[{tag}, {BF16}]")[:2]
                print(f"  deepapf_attention_bf16 [{tag}]: max_abs_err forward {e16[0]:.3g}, "
                      f"backward {e16[1]:.3g}", flush=True)
                continue
            fixed = 4 * (D * D + 3 * D)
            products = deepapf_products(P, D)
            record("deepapf_forward", lambda: b16.deepapf_forward(*args),
                   lambda: b16.deepapf_forward_plain(*args), err_f,
                   b16_step_bytes(tabs, pairs, 4), deepapf_work(P, D) - products,
                   tf32_ops=TF32_PRODUCTS_PER_SCORE * products,
                   library_fn=lambda: library_deepapf(*args))
            products = deepapf_products(P, D, True)
            record("deepapf_backward", lambda: b16.deepapf_backward(*args, gz),
                   lambda: b16.deepapf_backward_plain(*args, gz), err_b,
                   b16_step_bytes(tabs, pairs, 4, True), deepapf_work(P, D, True) - products,
                   tf32_ops=TF32_PRODUCTS_PER_SCORE * products,
                   library_fn=lambda: library_deepapf_backward(*args, gz))
            B = fs_users.shape[0]

            def library_grid():
                e, o = b16.grid_pairs(fs_users, grid_items, True)
                e, o = e.long(), o.long()
                return torch.sigmoid(library_deepapf_chain(share_t[e], only_t[e], other_t[o],
                                                           e > n_ov[side], w)).reshape(B, -1)

            n_pairs = B * n_target
            grid_bytes = 3 * (B + n_target) * D * 4 + 4 * n_pairs + fixed
            record("deepapf_grid", lambda: b16.deepapf_grid(*grid_args),
                   lambda: b16.deepapf_grid_plain(*grid_args), err_g, grid_bytes,
                   deepapf_work(n_pairs, D) - deepapf_products(n_pairs, D) + 3 * n_pairs,
                   tf32_ops=TF32_PRODUCTS_PER_SCORE * deepapf_products(n_pairs, D),
                   library_fn=library_grid, reps=20)
            # beside the 3xTF32 bound (the kernel's products): all of it on
            # the CUDA cores, the form of the parent's pair kernels
            cuda_core_ms = bound(grid_bytes, deepapf_work(n_pairs, D) + 3 * n_pairs)[0]
            print(f"  deepapf_grid: tiles of {min(8, B)} users x 16 items; bound on the CUDA "
                  f"cores {cuda_core_ms:.4f} ms", flush=True)
            b16_bf16_checks(record, args, gz, grid_args, masked)
        del tables

    # ---- B15: the target tower of CoNet over every target item -----------
    ev = FullSortEvaluator(config)
    B_dense, _ = ev._dense_budget(valid_data)
    assert B_dense == B15_USERS[-1], B_dense
    uids, row_ptr, items = _fused_eval_arrays(valid_data, B_dense, dev)
    k = ev.max_k
    for (D, hidden) in B15_TOWERS:
        dims = [2 * D] + hidden
        hi_all = rnd(n_target, hidden[0], scale=0.5)
        b0 = rnd(hidden[0], scale=0.1)
        layers = [(rnd(a, b, scale=(2 / (a + b)) ** 0.5), rnd(b, scale=0.1))
                  for a, b in zip(hidden, hidden[1:])]
        out = (rnd(hidden[-1], 1, scale=(2 / (hidden[-1] + 1)) ** 0.5), rnd(1, scale=0.1))
        for B in B15_USERS:
            hu = rnd(B, hidden[0], scale=0.5)
            got = b15.conet_tower(hu, hi_all, b0, layers, out)
            want = b15.conet_tower_plain(hu, hi_all, b0, layers, out)
            scale = b15_scale(hu, hi_all, b0, layers, out)
            tol = B15_TOL[0] + B15_TOL[1] * scale
            diff = (got - want).abs()
            err = float(diff.max())
            assert got.shape == (B, n_target) and bool((diff <= tol).all()), \
                f"conet_tower [D {D}, {hidden}, B {B}]: error {err}"
            assert torch.equal(got, b15.conet_tower(hu, hi_all, b0, layers, out))
            # a saturating call: every logit above 17, every probability 1.0
            sat_out = (out[0], out[1] + 40.0)
            sat = b15.conet_tower(hu, hi_all, b0, layers, sat_out)
            assert bool((sat == 1.0).all()) and torch.equal(
                sat, b15.conet_tower_plain(hu, hi_all, b0, layers, sat_out))
            print(f"  conet_tower [D {D}, tower {dims}, B {B}, I {n_target}]: max_abs_err "
                  f"{err:.3g} (at most {float((diff / tol).max()):.3g} of the tolerance); "
                  "saturated call all 1.0", flush=True)
            if B != B_dense or D != 64:
                continue
            # K4 on the tile: ids equal wherever neighbours are clear of the tolerance
            users = uids[:B]
            rp = row_ptr[0, :B + 1]
            a_i = k4.masked_topk(got, rp, items[0], k)
            b_i = k4.masked_topk(want, rp, items[0], k)
            b_s = torch.gather(want, 1, b_i.long())
            t_row = tol.max(1, keepdim=True).values
            gap = torch.diff(b_s, dim=1).abs() > t_row
            clear = torch.ones_like(gap[:, :1])
            clear = torch.cat([clear, gap], 1) & torch.cat([gap, clear], 1)
            assert torch.equal(a_i[clear], b_i[clear]), "conet_tower ids differ where clear"
            print(f"  conet_tower: K4 ids on the [{B}, {n_target}] tile equal where clear "
                  f"({int(clear.sum())} of {clear.numel()}); {users.shape[0]} eval users",
                  flush=True)
            widths = hidden
            n_bytes = 4 * ((B + n_target + 1) * hidden[0] + B * n_target
                           + sum(a * b + b for a, b in zip(widths, widths[1:])) + widths[-1] + 1)
            n_ops, products = conet_work(B * n_target, widths), conet_products(B * n_target,
                                                                               widths)
            tf32_ms = bound(n_bytes, n_ops - products, tf32_ops=3 * products)[0]
            print(f"  conet_tower: the published tower on wgmma, block tiles of 64 items x "
                  f"16 users, the products in 3xTF32; bound in 3xTF32 {tf32_ms:.4f} ms, on "
                  f"the CUDA cores "
                  f"{bound(n_bytes, n_ops)[0]:.4f} ms", flush=True)
            record("conet_tower", lambda: b15.conet_tower(hu, hi_all, b0, layers, out),
                   lambda: b15.conet_tower_plain(hu, hi_all, b0, layers, out), err,
                   n_bytes, n_ops - products, tf32_ops=3 * products,
                   library_fn=lambda: library_conet(hu, hi_all, b0, layers, out), reps=10)
            b15_bf16_checks(record, hu, hi_all, b0, layers, out)
        del hi_all


def check_b16_16(args, gz, masked, dt_name, tag):
    """B16's 16-bit forward and backward on ``args``' float32 operands
    rounded to ``dt_name`` against their plain versions (``B16_BF16_TOL``),
    the ``masked`` entities' share rows exactly 0, reruns bit-equal.
    Returns (the forward's and the backward's errors, the 16-bit operands,
    the 16-bit gradient)."""
    import torch

    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16

    tabs, pairs, overlapped, w = args
    dt = getattr(torch, dt_name)
    args16 = (b16.Tables(*(t.to(dt) for t in tabs)), pairs, overlapped,
              b16.Weights(*(t.to(dt) for t in w)))
    g16 = gz.to(dt)
    a = b16.deepapf_forward(*args16)
    err_f = close16(a, b16.deepapf_forward_plain(*args16), f"deepapf_forward_bf16 {tag}",
                    dt_name, B16_BF16_TOL)
    assert torch.equal(a, b16.deepapf_forward(*args16)), "deepapf_forward_bf16 differs run to run"
    ka = b16.deepapf_backward(*args16, g16)
    pa = b16.deepapf_backward_plain(*args16, g16)
    err_b = max(close16(x, y, f"deepapf_backward_bf16 {name} {tag}", dt_name, B16_BF16_TOL)
                for name, x, y in zip(B16_GRADS, ka, pa))
    assert not bool(ka[0][masked].any()) and bool(ka[0].any())
    assert all(torch.equal(x, y) for x, y in zip(ka, b16.deepapf_backward(*args16, g16))), \
        "deepapf_backward_bf16 differs run to run"
    return err_f, err_b, args16, g16


def b16_bf16_checks(record, args, gz, grid_args, masked):
    """B16-bf16's forward, backward and grid on the main path's operands of
    phase 2's float32 checks (a training step's pairs at D 64 from the five
    tables, the items the entity, and a fallback tile, its tables scaled by
    ``GRID16_SCALE``), rounded to bfloat16 (the records) and to float16
    (their ``shapes``), against their plain versions (forward and backward
    ``B16_BF16_TOL``, the grid's probabilities ``close_prob16`` with the
    float32 grid rounded only at its output a control that must fail), the
    ``masked`` entities' share rows exactly 0, reruns bit-equal, and timed:
    bounds the float32 forms' bytes on 2-byte operands, the products at the
    16-bit tensor rate; library routes the torch chains in 16 bits."""
    import torch

    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16

    tabs, pairs, _, w = args
    D = tabs.share.shape[1]
    P = pairs.ent_src.shape[0] + pairs.ent_tgt.shape[0]
    fixed = 2 * (D * D + 3 * D)
    share_t, only_t, other_t, users, items, n_ov, entity_is_item, _ = grid_args
    B, I = users.shape[0], items.shape[0]
    for dt_name in (BF16, "float16"):
        dt = getattr(torch, dt_name)
        tag = f"[D {D}, items the entity, {dt_name}]"
        err_f, err_b, args16, g16 = check_b16_16(args, gz, masked, dt_name, tag)
        tabs16, w16 = args16[0], args16[3]
        grid_tabs = [(GRID16_SCALE * t).to(dt) for t in (share_t, only_t, other_t)]
        gargs = (*grid_tabs, users, items, n_ov, entity_is_item, w16)
        c = b16.deepapf_grid(*gargs)
        want = b16.deepapf_grid_plain(*gargs)
        wide = b16.deepapf_grid(*(t.float() for t in grid_tabs), users, items, n_ov,
                                entity_is_item, b16.Weights(*(t.float() for t in w16)))
        err_g = close_prob16(c, want, f"deepapf_grid_bf16 {tag}",
                             {"constant 0.5": torch.full_like(want, 0.5),
                              "float32 grid rounded at its output": wide})
        assert torch.equal(c, b16.deepapf_grid(*gargs)), "deepapf_grid_bf16 differs run to run"
        print(f"  deepapf_attention_bf16 {tag}: max_abs_err forward {err_f:.3g}, backward "
              f"{err_b:.3g}, grid {err_g:.3g}", flush=True)
        shape = None if dt_name == BF16 else dt_name

        def library_grid():
            e, o = b16.grid_pairs(users, items, entity_is_item)
            e, o = e.long(), o.long()
            return torch.sigmoid(library_deepapf_chain(gargs[0][e], gargs[1][e], gargs[2][o],
                                                       e > n_ov, w16)).reshape(B, -1)

        record("deepapf_forward_bf16", lambda: b16.deepapf_forward(*args16),
               lambda: b16.deepapf_forward_plain(*args16), err_f,
               b16_step_bytes(tabs16, pairs, 2), deepapf_work(P, D) - deepapf_products(P, D),
               bf16_ops=deepapf_products(P, D),
               library_fn=lambda: library_deepapf(*args16), shape=shape)
        record("deepapf_backward_bf16", lambda: b16.deepapf_backward(*args16, g16),
               lambda: b16.deepapf_backward_plain(*args16, g16), err_b,
               b16_step_bytes(tabs16, pairs, 2, True),
               deepapf_work(P, D, True) - deepapf_products(P, D, True),
               bf16_ops=deepapf_products(P, D, True),
               library_fn=lambda: library_deepapf_backward(*args16, g16), shape=shape)
        record("deepapf_grid_bf16", lambda: b16.deepapf_grid(*gargs),
               lambda: b16.deepapf_grid_plain(*gargs), err_g,
               3 * (B + I) * D * 2 + 2 * B * I + fixed,
               deepapf_work(B * I, D) - deepapf_products(B * I, D) + 3 * B * I,
               bf16_ops=deepapf_products(B * I, D), library_fn=library_grid, reps=20,
               shape=shape)


def b15_bf16_checks(record, hu, hi, b0, layers, out):
    """B15-bf16 at the dense tile on phase 2's float32 operands rounded to
    bfloat16 (the record) and float16 (its ``shapes``): its probabilities
    against its plain version's by ``close_prob16``, the float32 kernel on
    the same 16-bit values rounded only at its output a control that must
    fail; 16-bit output, reruns bit-equal, and timed: bound the float32
    form's work on 2-byte operands, the products at the 16-bit tensor rate;
    library route JAX's whole-hidden form in 16 bits."""
    import torch

    from recbole_cdr_tpu_torch.ops import conet_tower as b15

    B, I, H0 = hu.shape[0], hi.shape[0], hu.shape[1]
    widths = [H0] + [W.shape[1] for W, _ in layers]
    for dt_name in (BF16, "float16"):
        dt = getattr(torch, dt_name)
        args = (hu.to(dt), hi.to(dt), b0.to(dt), [(W.to(dt), b.to(dt)) for W, b in layers],
                tuple(t.to(dt) for t in out))
        got = b15.conet_tower(*args)
        want = b15.conet_tower_plain(*args)
        assert got.dtype == want.dtype == dt and got.shape == (B, I)
        wide = b15.conet_tower(*(t.float() for t in args[:3]),
                               [(W.float(), b.float()) for W, b in args[3]],
                               tuple(t.float() for t in args[4]))
        err = close_prob16(got, want, f"conet_tower_bf16 [{dt_name}, B {B}, I {I}]",
                           {"constant 0.5": torch.full_like(want, 0.5),
                            "float32 tower rounded at its output": wide})
        del wide
        assert torch.equal(got, b15.conet_tower(*args)), "conet_tower_bf16 differs run to run"
        n_ops = conet_work(B * I, widths)
        products = conet_products(B * I, widths)
        record("conet_tower_bf16", lambda: b15.conet_tower(*args),
               lambda: b15.conet_tower_plain(*args), err,
               2 * ((B + I + 1) * H0 + B * I
                    + sum(a * b + b for a, b in zip(widths, widths[1:])) + widths[-1] + 1),
               n_ops - products, bf16_ops=products, library_fn=lambda: library_conet(*args),
               reps=10, shape=None if dt_name == BF16 else dt_name)


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
    if trainer.compute_dtype != torch.float32 and cfg.get("phase_optimizer") != "sparse":
        report_casts(trainer.model, trainer.compute_dtype, calls, tag)


def report_casts(model, dtype, calls, tag):
    """The per-call parameter cast of 16-bit compute, apart from the kernels:
    the trainer casts every floating parameter and buffer of the model (the
    CSRs' values and the degrees included) on each wrapped call, so each
    step and each evaluation tile pays one cast, also where the model then
    answers from its per-version cache (the sparse step casts its gathered
    sub-tables instead, which this does not time: its caller skips it).
    Prints the wrapped calls of each of
    ``calls`` (counted around ``utils.precision.call_with``), the device time
    of one cast, and their product."""
    import torch

    import recbole_cdr_tpu_torch.utils.precision as precision

    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    floats = [t for t in tensors.values() if t.is_floating_point()]
    n_bytes = sum(t.numel() * t.element_size() for t in floats)

    def cast():
        with torch.no_grad():
            return precision.cast_floats(tensors, dtype)

    cast_ms = device_ms(cast, 10)[0]
    real = precision.call_with
    for name, fn in calls:
        n = [0]

        def counting(*args, **kwargs):
            n[0] += 1
            return real(*args, **kwargs)

        precision.call_with = counting
        try:
            fn()
        finally:
            precision.call_with = real
        torch.cuda.synchronize()
        print(f"{tag}{name}: per-call parameter cast {n[0]} calls x {cast_ms:.4f} ms = "
              f"{n[0] * cast_ms:.3f} ms of device time ({len(floats)} tensors, "
              f"{n_bytes / 2 ** 20:.1f} MiB of float32 read per cast)", flush=True)


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
    if "--mesh" in sys.argv[1:]:
        gen_data()
        gen_catalog()
        refs = json.loads(sys.argv[sys.argv.index("--mesh") + 1])
        print(_MESH + json.dumps(run_mesh_paths(dev, refs)), flush=True)
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
        # ``--profile tag ...`` traces only the paths whose tag starts with
        # one of them (``natr_target``, ``deepapf``; the dense path's tag is
        # ``dense``); no tag traces every path
        only = sys.argv[sys.argv.index("--profile") + 1:]

        def trace(dev, cfg, tag="", *args, **kwargs):
            if not only or any((tag or "dense").startswith(t) for t in only):
                profile_epoch(dev, cfg, tag, *args, **kwargs)

        trace(dev, config_dict())
        trace(dev, bitgcf_config(), "bitgcf_", model="BiTGCF")
        for scheme in ("SOURCE", "TARGET"):
            trace(dev, natr_config(), f"natr_{scheme.lower()}_", model="NATR", scheme=scheme)
        for name, base, mode, epochs in DTCDR_RUNS[:3]:
            trace(dev, dtcdr_config(base, mode, epochs), f"{name}_", export=False,
                  model="DTCDR")
        for model, scheme, prelude in (("DCDCSR", "TARGET", ("SOURCE",)),
                                       ("DCDCSR", "BOTH", ("SOURCE", "TARGET")),
                                       ("EMCDR", "OVERLAP", ("SOURCE", "TARGET")),
                                       ("SSCDR", "OVERLAP", ("SOURCE", "TARGET"))):
            schedule = next(r[2] for r in MAPPING_RUNS if r[1] == model)
            trace(dev, mapping_config(model, schedule), f"{model.lower()}_{scheme.lower()}_",
                  export=False, model=model, scheme=scheme, prelude=prelude)
        for _, model, _ in PHASE11_RUNS:
            trace(dev, phase11_config(model), f"{model.lower()}_", export=False, model=model)
        for name, model, ref in PHASE12_RUNS:
            for scheme in ("SOURCE", "TARGET") if model == "NATR" else ("BOTH",):
                trace(dev, phase12_config(ref), f"{name}_{scheme.lower()}_", export=False,
                      model=model, scheme=scheme)
        for name, model, _ in PHASE13_RUNS:
            trace(dev, phase13_config(model), f"{name}_", export=False, model=model)
        trace(dev, popularity_cmf_config(), "popularity_cmf_", export=False)
        trace(dev, popularity_emcdr_config(), "popularity_emcdr_source_", export=False,
              model="EMCDR", scheme="SOURCE")
        trace(dev, catalog_config(), "catalog_", export=False)  # traces of ~100 MB
        trace(dev, bf16_catalog_config(), "bf16_catalog_", export=False)
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
    c = counts["dense"]  # one plan launch (both tables' ids) per K1 backward
    assert c["group_rows"] == c["gather_dot_backward"], c
    check_repeats("CMF", config_dict(), result, saved=False)

    print("== phase 4: catalog path, run_recbole_cdr(model='CMF', phase_optimizer='sparse') "
          "with streaming evaluation", flush=True)
    # each validation records the process's peak allocation so far, an upper
    # bound of its own: count it from this run
    del result
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rescans = k1_rescans(dev)
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="CMF", config_dict=catalog_config(), saved=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["catalog"] = c = ops.launch_counts()
    hist = _report_run(result, wall, counts["catalog"], CATALOG_PATH)
    # K1 reads the step's sub-tables by position: one plan per B6 call
    assert c["group_rows"] == c["sparse_adam"] == 2 * c["gather_dot_backward"], c
    check_no_rescans(dev, rescans, "phase 4")
    model = result["model"]
    assert all(p.grad is None for p in model.parameters()), "a table gradient was allocated"
    state = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"parameters + moments {state / 2 ** 30:.3f} GiB; peak allocation up to each "
          "validation " + ", ".join(f"{h['valid_peak_bytes'] / 2 ** 30:.3f} GiB" for h in hist),
          flush=True)
    assert all(h["valid_peak_bytes"] - state < CATALOG_EVAL_HEADROOM for h in hist), hist
    assert len(hist) == CATALOG_EPOCHS and hist[1]["loss"] < hist[0]["loss"], hist
    catalog_recall = result["test_result"]["recall@10"]

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
    recalls = {"bitgcf": result["test_result"]["recall@10"]}
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
    recalls["natr"] = result["test_result"]["recall@10"]
    check_repeats("NATR", natr_config(), result, saved=True)

    print("== phase 7: DTCDR paths, run_recbole_cdr(model='DTCDR') on the card: NeuMF and DMF, "
          "full-sort, candidate and labeled evaluation", flush=True)
    del result
    torch.cuda.empty_cache()
    recalls["dtcdr_dmf"] = run_dtcdr_paths(counts)["dtcdr_dmf"]["recall@10"]

    print("== phase 8: mapping paths, run_recbole_cdr(model='DCDCSR' | 'EMCDR' | 'SSCDR') on "
          "the card: pairwise and OVERLAP streams, the host batch path, B12", flush=True)
    torch.cuda.empty_cache()
    refs = {"mapping": run_mapping_paths(counts, records)}

    print("== phase 9: mixed precision and popularity negatives: the catalog path in bf16, "
          "CMF with popularity negatives and adagrad, EMCDR BPR with popularity negatives "
          "and rmsprop", flush=True)
    torch.cuda.empty_cache()
    refs["bf16_catalog"] = run_precision_and_popularity_paths(counts, records, catalog_recall)

    print("== phase 10: mesh: B14 against B5, the catalog path over a one-rank NCCL mesh, "
          "the host path under it; phase 14 in the same child: the bf16 sparse catalog "
          "(B6's row-shard form) and the mapping models over the mesh", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh",
                            json.dumps(refs)], stdout=subprocess.PIPE, text=True, check=True)
    mesh = None
    for line in child.stdout.splitlines():
        if line.startswith(_MESH):
            mesh = json.loads(line[len(_MESH):])
        else:
            print(line, flush=True)
    assert mesh is not None, "the mesh phase reported no results"
    records.update(mesh["records"])
    for name, shapes in mesh["b6_shapes"].items():  # B6's and its plan's
        records[name].setdefault("shapes", {}).update(shapes)
    counts.update(mesh["counts"])
    print(f"mesh phase took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 11: CLFM, DeepAPF and CoNet, run_recbole_cdr on the card: B16 in "
          "training and the predict fallback, B15 in the dense evaluation", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    allocs = {}
    run_phase11_paths(counts, recalls, allocs)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 12: BiTGCF, NATR and DTCDR DMF under compute_dtype bfloat16: the 16-bit "
          "forms of B8, B9 and B11", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_phase12_paths(counts, recalls)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 13: DeepAPF and CoNet under compute_dtype bfloat16: the 16-bit forms of "
          "B16 and B15", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_phase13_paths(counts, recalls, allocs)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    replaces = {
        "gather_dot_forward": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                               "recbole_cdr_tpu/models/cmf.py:45"),
        "gather_dot_backward": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                                "recbole_cdr_tpu/models/cmf.py:45"),
        "neg_sampler": ("recbole_cdr_tpu_torch/csrc/neg_sampler.cu",
                        "recbole_cdr_tpu/trainer/device_loop.py:205"),
        "swap_or_not": ("recbole_cdr_tpu_torch/csrc/shuffle.cu",
                        "recbole_cdr_tpu/trainer/device_loop.py:483"),
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
        "gather_dot_forward_bf16": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                                    "recbole_cdr_tpu/models/cmf.py:45"),
        "gather_dot_backward_bf16": ("recbole_cdr_tpu_torch/csrc/gather_dot.cu",
                                     "recbole_cdr_tpu/models/cmf.py:45"),
        "streaming_topk_bf16": ("recbole_cdr_tpu_torch/csrc/streaming_topk.cu",
                                "recbole_cdr_tpu/evaluator/evaluator.py:511"),
        "neg_sampler_popularity": ("recbole_cdr_tpu_torch/csrc/neg_sampler.cu",
                                   "recbole_cdr_tpu/trainer/device_loop.py:250"),
        "sharded_topk_local": ("recbole_cdr_tpu_torch/csrc/streaming_topk.cu",
                               "recbole_cdr_tpu/ops/topk.py:208"),
        "sharded_topk_merge": ("recbole_cdr_tpu_torch/csrc/streaming_topk.cu",
                               "recbole_cdr_tpu/ops/topk.py:253"),
        "conet_tower": ("recbole_cdr_tpu_torch/csrc/conet_tower.cu",
                        "recbole_cdr_tpu/models/conet.py:150"),
        "deepapf_forward": ("recbole_cdr_tpu_torch/csrc/deepapf_attention.cu",
                            "recbole_cdr_tpu/models/deepapf.py:70"),
        "deepapf_backward": ("recbole_cdr_tpu_torch/csrc/deepapf_attention.cu",
                             "recbole_cdr_tpu/models/deepapf.py:70"),
        "deepapf_grid": ("recbole_cdr_tpu_torch/csrc/deepapf_attention.cu",
                         "recbole_cdr_tpu/models/deepapf.py:70"),
        "group_rows": ("recbole_cdr_tpu_torch/csrc/row_groups.cu",
                       "recbole_cdr_tpu/trainer/trainer.py:274"),
        "row_sum": ("recbole_cdr_tpu_torch/csrc/row_groups.cu",
                    "recbole_cdr_tpu/parallel/mesh.py:131"),
    }
    for name in ("graph_layer_forward", "graph_layer_backward", "natr_attention_forward",
                 "natr_attention_backward", "natr_anchor_table", "natr_pair_grid",
                 "rating_vector_forward", "rating_vector_backward", "conet_tower",
                 "deepapf_forward", "deepapf_backward", "deepapf_grid"):
        replaces[BF16_FORMS[name]] = replaces[name]
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
    # the plans: one per K1 backward (both source tables in one launch), one
    # per B9 forward (the step's anchor ids)
    want = {"gather_dot_forward": steps["SOURCE"], "gather_dot_backward": steps["SOURCE"],
            "group_rows": steps["SOURCE"] + steps["TARGET"],
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
    counts go into ``counts`` under the run's name. ``DTCDR_REPEATED`` runs
    a second time (``check_repeats``)."""
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
        if name == DTCDR_REPEATED:
            check_repeats("DTCDR", cfg, result, saved=True)
        del result
    # ~100x fewer candidates than full-sort
    assert tests["dtcdr_uniform"]["hit@10"] > tests["dtcdr_dmf"]["hit@10"], tests
    return tests


def check_repeats(model, cfg, first, saved):
    """The run of ``model`` under ``cfg`` (``run_recbole_cdr``'s ``saved``)
    again with the same seed (its launches counted in no path): its trained
    parameters bit-equal to ``first``'s, every epoch's loss and every metric
    equal."""
    import torch

    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    counts = ops.launch_counts()
    t0 = time.perf_counter()
    second = run_recbole_cdr(model=model, config_dict=cfg, saved=saved)
    torch.cuda.synchronize()
    added = time.perf_counter() - t0
    for name, fn in ops.WRAPPERS.items():  # the first run's counts stay its own
        fn.launches = counts[name]
    a, b = first["model"].state_dict(), second["model"].state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    losses = [[h["loss"] for h in r["history"]] for r in (first, second)]
    print(f"repeated {model} run (+{added:.2f} s): {len(a) - len(differ)} of {len(a)} "
          f"parameters bit-equal; losses {losses[0]} and {losses[1]}; test "
          f"{second['test_result']}", flush=True)
    assert sorted(a) == sorted(b) and not differ, f"parameters differ run to run: {differ}"
    assert losses[0] == losses[1], losses
    assert first["test_result"] == second["test_result"], (first["test_result"],
                                                           second["test_result"])
    assert first["best_valid_result"] == second["best_valid_result"]


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
                "rating_vector_backward": B11_PER_STEP * steps,
                "group_rows": B11_PLANS_PER_STEP * (steps + passes)}
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
    ``records``. Returns {run name: {"test": its test metrics, "losses":
    [(phase, loss) per epoch]}} (phase 14c's references)."""
    import torch

    import recbole_cdr_tpu_torch.models.dcdcsr as dcdcsr_module
    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    captured = []
    real = dcdcsr_module.benchmark_topk

    def capture(*args):  # the wrapper itself counts the launch
        captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    dcdcsr_module.benchmark_topk = capture
    tests = {}
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
            tests[name] = {"test": result["test_result"],
                           "losses": [(h["phase"], h["loss"]) for h in hist]}
            del result
            torch.cuda.empty_cache()
    finally:
        dcdcsr_module.benchmark_topk = real
    assert len(captured) == 1, len(captured)
    check_b12(captured[0], records)
    return tests


def bf16_catalog_config():
    """Phase 9a: the catalog path under ``compute_dtype`` and
    ``eval_score_dtype`` bfloat16 (float32 master parameters and SparseAdam
    state)."""
    return {**catalog_config(), "compute_dtype": "bfloat16", "eval_score_dtype": "bfloat16"}


#: the learning rates of phases 9b and 9c. Both learners divide by a root
#: that starts far above the squared gradients of a mean loss over 8,192
#: pairs: phase 9b prints the first step's gradient RMS per entry of the
#: rows it touched, about 6e-7 on the dense pair (9c's is about 1.3e-6).
#: Adagrad's accumulator starts at 0.1 and rmsprop's eps 1e-8 sits inside
#: its root, so a step moves an entry by about ``lr * g / sqrt(0.1)`` or
#: ``lr * g / 1e-4`` until the gradients grow: some 6e-4 and 4e-4 at these
#: rates, 1e-5 and 1.3e-5 at optax's usual 1e-3, which leave the scores
#: near 0 and the loss flat. Above 0.03 rmsprop's steps throw EMCDR's
#: mapping phase off (its first epoch's loss in the hundreds)
ADAGRAD_LR = 300.0
RMSPROP_LR = 0.03
#: a learner that learns lowers each phase's epoch loss by more than this
#: share from its first epoch to its last; with scores near 0 every epoch's
#: loss stays within about 3e-5 of n ln 2 (its BCE or BPR terms at score 0),
#: whatever the negatives ...
LEARN_LOSS_DROP = 1e-3
#: ... and reaches a test Recall@10 this many times a random ranking's
#: (k over the target items not in the user's training history)
LEARN_RECALL_OVER_RANDOM = 5
def popularity_cmf_config():
    """Phase 9b: CMF on the dense pair, popularity negatives, adagrad (the
    default ``phase_optimizer: single`` falls back to per phase)."""
    return {**config_dict(), "embedding_size": 64, "neg_sampling": {"popularity": 1},
            "learner": "adagrad", "learning_rate": ADAGRAD_LR}


def popularity_emcdr_config():
    """Phase 9c: EMCDR's BPR form at its published width on the dense pair,
    popularity negatives, rmsprop."""
    return {**mapping_config("EMCDR", POPULARITY_EMCDR_SCHEDULE), "loss_type": "BPR",
            "latent_factor_model": "BPR", "neg_sampling": {"popularity": 1},
            "learner": "rmsprop", "learning_rate": RMSPROP_LR,
            "phase_optimizer": "per_phase"}


def run_precision_and_popularity_paths(counts, records, catalog_recall):
    """Phase 9: (a) the catalog path in bf16: K1's bf16 form once forward
    and once backward per step, B6, K2, K3, and B13 once per streaming tile
    of every validation and the test pass, never B5; the loss falls, the
    metrics are finite and the peak allocation stays under phase 4's limit;
    (b) CMF with popularity negatives and adagrad and (c) EMCDR BPR with
    popularity negatives and rmsprop: B2a once per epoch and stream, never
    K2; every phase's loss drops by more than ``LEARN_LOSS_DROP`` and the
    test Recall@10 reaches ``LEARN_RECALL_OVER_RANDOM`` times a random
    ranking's; the metrics are finite. (b) prints the first step's gradient
    RMS and the empirical negative frequency of the target domain's 10 most
    popular items beside their popularity shares. Then the kernels are held
    against their plain versions at these paths' own shapes and timed into
    ``records``: K1-bf16 on the first sparse step of (a) (its sub-tables),
    every B2a call of (b) and (c) exactly, the largest timed. Returns (a)'s
    test Recall@10 and its epochs' seconds and losses (phase 14b's
    reference)."""
    import numpy as np
    import torch

    import recbole_cdr_tpu_torch.ops.gather_dot as k1
    import recbole_cdr_tpu_torch.trainer.device_loop as loop_module
    import recbole_cdr_tpu_torch.trainer.trainer as trainer_module
    from recbole_cdr_tpu_torch import ops, run_recbole_cdr
    from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator

    print("-- 9a: catalog path, compute_dtype and eval_score_dtype bfloat16", flush=True)
    k1_step = []
    real_k1 = k1._backward

    def capture_k1(U, I, u, i, g, groups, name):  # the launcher under the counting wrapper
        if not k1_step and name == "gather_dot_backward_bf16":
            k1_step.append((*(t.clone() for t in (U, I, u, i, g)),
                            tuple(s == k1.POSITIONS for s in groups)))
        return real_k1(U, I, u, i, g, groups, name)

    k1._backward = capture_k1
    rescans = k1_rescans("cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_recbole_cdr(model="CMF", config_dict=bf16_catalog_config(), saved=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        k1._backward = real_k1
    counts["bf16_catalog"] = c = ops.launch_counts()
    check_no_rescans("cuda", rescans, "9a")
    hist = _report_run(result, wall, c, BF16_CATALOG_PATH)
    model = result["model"]
    assert all(p.dtype == torch.float32 and p.grad is None for p in model.parameters())
    state = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    assert all(h["valid_peak_bytes"] - state < CATALOG_EVAL_HEADROOM for h in hist), hist
    assert len(hist) == CATALOG_EPOCHS and hist[-1]["loss"] < hist[0]["loss"], hist
    block = FullSortEvaluator.STREAM_USER_BLOCK
    tiles = sum(-(-h["valid_users"] // block) for h in hist) + -(-result["test_users"] // block)
    # a BOTH step: each domain's BATCH slots (positives and their negatives)
    steps = sum(h["train_examples"] for h in hist) // (2 * BATCH)
    # K1 reads the step's sub-tables by position: the plans are B6's alone
    want = {"streaming_topk_bf16": tiles, "gather_dot_forward_bf16": steps,
            "gather_dot_backward_bf16": steps, "sparse_adam": 2 * steps,
            "group_rows": 2 * steps}
    print(f"{steps} steps, {tiles} streaming tiles; launches {({k: c[k] for k in want})}, "
          f"expected {want}; peak allocation up to each validation "
          + ", ".join(f"{h['valid_peak_bytes'] / 2 ** 30:.3f} GiB" for h in hist), flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)
    print(f"test recall@10: bf16 {result['test_result']['recall@10']} beside float32 "
          f"{catalog_recall} (phase 4)", flush=True)
    ref_9a = {"recall@10": result["test_result"]["recall@10"],
              "epochs": [{k: h[k] for k in ("train_seconds", "valid_seconds", "loss")}
                         for h in hist]}
    del model
    check_repeats("CMF", bf16_catalog_config(), result, saved=False)
    del result
    torch.cuda.empty_cache()

    drawn = []
    grad_rms = []
    real_b2a = loop_module.sample_negatives_popularity

    def capture_b2a(base, accept, uids, hist_m, alias, neg_num, lens):
        out = real_b2a(base, accept, uids, hist_m, alias, neg_num, lens)
        assert lens is not None, "the device loop draws without its rows' live lengths"
        drawn.append((base, accept, uids, hist_m, alias, neg_num, lens, out.clone()))
        return out

    real_steps = {cls: cls.step for cls in (trainer_module.OptaxAdagrad,
                                            trainer_module.OptaxRMSprop)}

    def first_step_rms(real_step):
        def step(self):
            if not grad_rms:  # the entries of the rows the step's pairs touched
                g = torch.cat([p.grad[p.grad.abs().sum(-1) > 0].flatten()
                               for grp in self.param_groups for p in grp["params"]
                               if p.grad is not None and p.grad.dim() == 2])
                grad_rms.append(float(g.pow(2).mean().sqrt()))
            return real_step(self)
        return step

    for name, model, cfg, path, schedule in (
            ("popularity_cmf", "CMF", popularity_cmf_config(), POPULARITY_CMF_PATH,
             ("BOTH",)),
            ("popularity_emcdr", "EMCDR", popularity_emcdr_config(), POPULARITY_EMCDR_PATH,
             POPULARITY_EMCDR_SCHEDULE)):
        print(f"-- {'9b' if model == 'CMF' else '9c'}: {model}, popularity negatives, "
              f"{cfg['learner']} at lr {cfg['learning_rate']}, {', '.join(cfg['train_epochs'])}",
              flush=True)
        first = len(drawn)
        grad_rms.clear()
        loop_module.sample_negatives_popularity = capture_b2a
        for cls, real_step in real_steps.items():
            cls.step = first_step_rms(real_step)
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = run_recbole_cdr(model=model, config_dict=cfg, saved=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loop_module.sample_negatives_popularity = real_b2a
            for cls, real_step in real_steps.items():
                cls.step = real_step
        counts[name] = c = ops.launch_counts()
        hist = _report_run(result, wall, c, path)
        print(f"first {cfg['learner']} step: gradient RMS {grad_rms[0]:.4g} per entry of the "
              "touched rows", flush=True)
        for phase in schedule:
            losses = [h["loss"] for h in hist if h["phase"] == phase]
            assert len(losses) > 1 and losses[-1] < (1 - LEARN_LOSS_DROP) * losses[0], \
                (phase, losses)
        tmodel = result["model"]
        n_target = tmodel.target_num_items
        # a random ranking's Recall@10 is k over a user's candidates: the
        # target items less the PAD id and its training history, which
        # gen_data caps at 5% of the items
        random_recall = 10 / (n_target - 1 - max(50, N_TGT_ITEMS // 20))
        recall = result["test_result"]["recall@10"]
        print(f"test recall@10 {recall} against a random ranking's {random_recall:.5f}",
              flush=True)
        assert recall >= LEARN_RECALL_OVER_RANDOM * random_recall, (recall, random_recall)
        streams = sum(2 if h["phase"] == "BOTH" else int(h["phase"] != "OVERLAP")
                      for h in hist)
        print(f"B2a launches {c['neg_sampler_popularity']}, expected {streams} (one per "
              "epoch and stream)", flush=True)
        assert c["neg_sampler_popularity"] == streams == len(drawn) - first, (c, streams)
        if model == "CMF":
            # the target stream's draws: its alias table holds target item
            # ids only (the source's also holds source-only ids, above them)
            tgt = [(d[4], d[7]) for d in drawn[first:] if int(d[4][0].max()) < n_target]
            share = alias_shares(tgt[0][0], n_target)
            neg = torch.cat([out for _, out in tgt]).cpu().numpy()
            freq = np.bincount(neg, minlength=n_target) / len(neg)
            top = np.argsort(-share)[:10]
            print("target negatives, the 10 most popular items (item: popularity share, "
                  "negative frequency): " + "; ".join(
                      f"{i}: {share[i]:.5f}, {freq[i]:.5f}" for i in top), flush=True)
        del result, tmodel
        torch.cuda.empty_cache()

    print("-- the kernels of phase 9 at its own shapes", flush=True)
    Ub, Ib, u, i, gb, positions = k1_step[0]
    assert all(positions), "9a's K1 did not read its sub-tables by position"
    check_k1(main_path_recorder(records, "9a, the first sparse step's sub-tables"),
             Ub, Ib, u, i, gb, positions)
    check_k1(main_path_recorder(records, "9a's first sparse step's sub-tables in float32"),
             Ub.float(), Ib.float(), u, i, gb.float(), positions)
    for call in drawn:
        check_b2a(None, call)
    largest = max(drawn, key=lambda d: d[2].shape[0])
    print(f"B2a: all {len(drawn)} calls of 9b and 9c equal to the plain version; timed at "
          f"the largest, {largest[2].shape[0]} slots on history [{largest[3].shape[0]}, "
          f"{largest[3].shape[1]}]", flush=True)
    check_b2a(main_path_recorder(records, "9b, the largest B2a call"), largest)
    return ref_9a


def alias_shares(alias, n_items):
    """The law an alias table draws from, per item id: each column keeps
    ``prob`` of its 1/n share (all of it when its alias is -1) and hands the
    rest to its alias column. These are the popularity shares of the
    interactions the sampler counted."""
    import numpy as np

    values, prob, ali = (t.cpu().numpy() for t in alias)
    n = len(values)
    keep = np.where(ali < 0, 1.0, prob.astype(np.float64))
    share = np.bincount(values, weights=keep / n, minlength=n_items)
    moved = ali >= 0
    share += np.bincount(values[ali[moved]], weights=(1.0 - keep[moved]) / n,
                         minlength=n_items)
    return share


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
    again = b12.benchmark_topk(*args)
    assert torch.equal(idx, again[1]) and torch.equal(sim, again[2]), "B12 differs run to run"
    assert torch.equal(out.nan_to_num(7.0), again[0].nan_to_num(7.0)), "B12 differs run to run"
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
          f"at the k-th, {int(torch.isnan(out).any(1).sum())} NaN rows (sn + t_pop = 0); "
          "two runs bit-equal", flush=True)
    n_rows = M - int(zero.sum())  # the rows the screen takes
    splits, span = b12.benchmark_topk_plan(
        max(n_rows, 1), n_ov, k,
        torch.cuda.get_device_properties(rest.device).multi_processor_count)
    print(f"B12's plan: {n_rows} of {M} rows hold a value other than 0, "
          f"{-(-n_rows // b12.ROWS)} row blocks x {splits} column ranges of {span} source rows, "
          f"{b12.blocks_per_sm(k)} blocks an SM, {b12.screen_smem_bytes(k)} bytes of shared "
          "memory a block", flush=True)

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
    # the kernel's work on this run's tables: the product of the rows that
    # hold a value other than 0 in 3xTF32 on the tensor cores, the form B5
    # computes its scores in, and at least the k results' float32 chains a
    # row on the CUDA cores (an all-zero row's similarities are 0 unread)
    make_recorder(records)("benchmark_topk", lambda: b12.benchmark_topk(*args),
                           lambda: b12.benchmark_topk_plain(*args), err, n_bytes,
                           2 * n_rows * k * D, library_fn=library,
                           tf32_ops=TF32_PRODUCTS_PER_SCORE * 2 * n_rows * n_ov * D)
    # beside it, every row's product: in 3xTF32, and on the CUDA cores in
    # float32 as the reference computes it (the first design's bound)
    records["benchmark_topk"]["tf32_bound_ms"] = (
        TF32_PRODUCTS_PER_SCORE * flops / PEAK_TF32_OPS_PER_S * 1e3)
    records["benchmark_topk"]["cuda_core_bound_ms"] = bound(n_bytes, flops)[0]
    print(f"  benchmark_topk bounds: {n_rows} rows' product in 3xTF32 "
          f"{records['benchmark_topk']['bound_ms']:.4f} ms; every row's in 3xTF32 "
          f"{records['benchmark_topk']['tf32_bound_ms']:.4f} ms, float32 on the CUDA cores "
          f"{records['benchmark_topk']['cuda_core_bound_ms']:.4f} ms", flush=True)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_config(base):
    """``base`` over a one-rank (data 1 x model 1) mesh whose NCCL group
    meets on ``tcp://127.0.0.1:<free port>``."""
    return {**base, "mesh_shape": {"data": 1, "model": 1},
            "distributed": {"coordinator_address": f"127.0.0.1:{_free_port()}",
                            "num_processes": 1, "process_id": 0}}


def mesh_catalog_config():
    """Phase 10b's configuration without the mesh: the catalog path at CMF's
    published width with dense Adam, ``MESH_EPOCHS`` epochs."""
    return {**catalog_config(), "phase_optimizer": "single",
            "train_epochs": [f"BOTH:{MESH_EPOCHS}"]}


def mesh_host_config():
    """Phase 10c's configuration without the mesh: the dense pair on the host
    batch path, BOTH:2."""
    return {**config_dict(), "device_side_sampling": False, "train_epochs": ["BOTH:2"]}


def check_b14(dev, record):
    """Phase 10a: B14 at phase 4's streaming tile (``B14_TILE``, a history of
    0-64 random items a row, one row of 400) for every width of
    ``B14_SHARDS``, the table split into shards of ceil(I / m) rows whose
    last is padded with rows of 100 (they would win every row if they
    competed). Holds the local stages and the merge against one B5 call over
    the whole table and against the plain version (see the phase's entry in
    the module's docstring), then times each stage at one shard (the last:
    a nonzero offset and the pad rows) into ``record``, one shard (the whole
    table, the main path's width) as the top-level record."""
    import torch

    from recbole_cdr_tpu_torch.ops import topk as b5

    B, D, I, k = B14_TILE
    g = torch.Generator(device=dev).manual_seed(14)
    deg = torch.randint(0, 65, (B,), generator=torch.Generator().manual_seed(14))
    deg[0] = 400
    rp = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    rp[1:] = torch.cumsum(deg, 0).to(dev)
    it = torch.randint(1, I, (int(deg.sum()),), dtype=torch.int32, device=dev, generator=g)
    rows_h = torch.repeat_interleave(torch.arange(B, device=dev), deg.to(dev))
    neg = torch.finfo(torch.float32).min

    def split(T, m):
        L = -(-I // m)
        pad = torch.full((L * m - I, D), 100.0, dtype=T.dtype, device=dev)
        return L, torch.cat([T, pad]).split(L)

    def lists(local, U, shards, L):
        out = [local(U, s, rp, it, k, j * L, I) for j, s in enumerate(shards)]
        return torch.stack([s for s, _ in out]), torch.stack([i for _, i in out])

    def b14(U, shards, L):
        return b5.sharded_topk_merge(*lists(b5.sharded_topk_local, U, shards, L), k)

    def plain(U, shards, L):
        return b5.sharded_topk_merge_plain(*lists(b5.sharded_topk_local_plain, U, shards, L), k)

    def clear_of_ties(want_s, tol):
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        edge = torch.ones_like(gap[:, :1])
        return torch.cat([edge, gap], 1) & torch.cat([gap, edge], 1)

    Ui = torch.randint(-3, 4, (B, D), device=dev, generator=g).float()
    Ti = torch.randint(-3, 4, (I, D), device=dev, generator=g).float()
    Un = torch.randn(B, D, device=dev, generator=g)
    Tn = torch.randn(I, D, device=dev, generator=g)
    one_i, one_n = b5.streaming_topk(Ui, Ti, rp, it, k), b5.streaming_topk(Un, Tn, rp, it, k)
    errs = {}
    for m in B14_SHARDS:
        L, shards = split(Ti, m)
        a, p = b14(Ui, shards, L), plain(Ui, shards, L)
        assert all(torch.equal(x, y) for x, y in zip(a, one_i)), f"B14 at m={m} differs from B5"
        assert all(torch.equal(x, y) for x, y in zip(a, p)), f"B14 at m={m} differs from plain"
        L, shards = split(Tn, m)
        (a_s, a_i), (p_s, p_i) = b14(Un, shards, L), plain(Un, shards, L)
        tol = B5_TOL[0] + B5_TOL[1] * p_s.abs()
        errs[m] = float((a_s - p_s).abs().max())
        assert bool(((a_s - p_s).abs() <= tol).all()), f"B14 at m={m}: score error {errs[m]}"
        clear = clear_of_ties(p_s, tol)
        assert torch.equal(a_i[clear], p_i[clear]), f"B14 at m={m}: ids differ off near ties"
        print(f"  B14 at m={m}: integer factors equal B5 and the plain version exactly; normal "
              f"factors max error {errs[m]:.3g}, {int(clear.sum())} of {clear.numel()} ids clear "
              f"of a near tie, all equal; ids equal to B5's call {bool(torch.equal(a_i, one_n[1]))}, "
              f"scores {bool(torch.equal(a_s, one_n[0]))}", flush=True)
    # bf16 once, against B13
    m = B14_SHARDS[-1]
    Ub, Tb = Ui.to(torch.bfloat16), Ti.to(torch.bfloat16)
    L, shards = split(Tb, m)
    a, one = b14(Ub, shards, L), b5.streaming_topk_bf16(Ub, Tb, rp, it, k)
    assert all(torch.equal(x, y) for x, y in zip(a, one)), "B14 in bf16 differs from B13"
    Ub, Tb = Un.to(torch.bfloat16), Tn.to(torch.bfloat16)
    L, shards = split(Tb, m)
    (a_s, a_i), (p_s, p_i) = b14(Ub, shards, L), plain(Ub, shards, L)
    absum = (Ub.float().abs()[:, None, :] * Tb.float().abs()[p_i.long()]).sum(-1)
    tol = B13_TOL[0] + B13_TOL[1] * absum
    assert bool(((a_s - p_s).abs() <= tol).all()), "B14 in bf16: score error"
    assert torch.equal(a_i[clear_of_ties(p_s, tol)], p_i[clear_of_ties(p_s, tol)])
    print(f"  B14 in bf16 at m={m}: integer factors equal B13 exactly; normal factors max "
          f"error {float((a_s - p_s).abs().max()):.3g}", flush=True)
    del Ub, Tb, Ui, Ti

    for m in B14_SHARDS:
        L, shards = split(Tn, m)
        off = (m - 1) * L
        shard = shards[-1]
        n = min(L, I - off)
        sel = (it >= off) & (it < off + n)
        rows_s, it_s = rows_h[sel], (it[sel] - off).long()

        def library_local():
            sc = Un @ shard[:n].T
            sc[rows_s, it_s] = neg
            if off == 0:
                sc[:, 0] = neg
            return torch.topk(sc, k, dim=1).indices

        shape = None if m == 1 else f"m={m}"
        record("sharded_topk_local",
               lambda: b5.sharded_topk_local(Un, shard, rp, it, k, off, I),
               lambda: b5.sharded_topk_local_plain(Un, shard, rp, it, k, off, I),
               errs[m], n * D * 4 + B * D * 4 + (B + 1 + int(rp[-1])) * 4 + B * k * 8, 0,
               library_fn=library_local, reps=10, shape=shape,
               tf32_ops=TF32_PRODUCTS_PER_SCORE * 2 * B * n * D)
        cs, ci = lists(b5.sharded_topk_local, Un, shards, L)
        ref = b5.sharded_topk_merge_plain(cs, ci, k)
        got = b5.sharded_topk_merge(cs, ci, k)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
            f"sharded_topk_merge differs from its plain version at m={m}"
        cat_s, cat_i = cs.transpose(0, 1).reshape(B, m * k), ci.transpose(0, 1).reshape(B, m * k)

        def library_merge():
            v, pos = torch.topk(cat_s, k, dim=1)
            return v, cat_i.gather(1, pos)

        record("sharded_topk_merge", lambda: b5.sharded_topk_merge(cs, ci, k),
               lambda: b5.sharded_topk_merge_plain(cs, ci, k), 0.0, (m + 1) * B * k * 8,
               m * B * k, library_fn=library_merge, shape=shape)
    floor = device_ms(lambda: torch.cuda._sleep(0))[0]
    print(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) {floor:.4f} ms a launch, "
          "queued as the records' calls", flush=True)


def run_mesh_paths(dev, refs):
    """Phase 10 (the ``--mesh`` child): 10a ``check_b14``, then the 10b and
    10c runs with their checks; then phase 14 (``run_phase14_paths``) against
    ``refs``, phase 9a's and phase 8's results. Returns {"records": B14's
    records, "b6_shapes": the row-shard records of B6 and its plan by kernel,
    "counts": {"mesh": 10b's launch counts, "mesh_host": 10c's, and phase
    14's}}."""
    import torch
    import torch.distributed as dist

    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    records = {}
    print("-- 10a: B14's local stage and merge against B5 at phase 4's streaming tile",
          flush=True)
    t0 = time.perf_counter()
    check_b14(dev, make_recorder(records))
    torch.cuda.empty_cache()
    print(f"10a took {time.perf_counter() - t0:.1f} s", flush=True)

    print("-- 10b: the catalog path, dense Adam, over a one-rank NCCL mesh", flush=True)
    counts = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="CMF", config_dict=mesh_config(mesh_catalog_config()),
                             saved=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["mesh"] = c = ops.launch_counts()
    hist = _report_run(result, wall, c, MESH_CATALOG_PATH)
    assert not dist.is_initialized(), "the run left its process group behind"
    assert len(hist) == MESH_EPOCHS and hist[-1]["loss"] < hist[0]["loss"], hist
    tiles = sum(-(-u // min(2048, u)) for u in
                [h["valid_users"] for h in hist if "valid_users" in h] + [result["test_users"]])
    want = {"sharded_topk_local": tiles, "sharded_topk_merge": tiles}
    print(f"{tiles} streaming tiles (validations and the test pass); B14 launches "
          f"{ {n: c[n] for n in want} }, expected {want}", flush=True)
    assert all(c[n] == v for n, v in want.items()), (c, want)
    mesh_test = result["test_result"]
    del result
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = run_recbole_cdr(model="CMF", config_dict=mesh_catalog_config(), saved=False)
    torch.cuda.synchronize()
    print(f"the same run without the mesh (B5): wall {time.perf_counter() - t0:.2f} s", flush=True)
    for h, r in zip(hist, ref["history"]):
        print(f"  epoch {h['epoch']}: train {h['train_seconds']:.4f} s on the mesh, "
              f"{r['train_seconds']:.4f} s without; validation {h['valid_seconds']:.4f} s, "
              f"{r['valid_seconds']:.4f} s; loss {h['loss']:.6f}, {r['loss']:.6f}", flush=True)
    print(f"test: {ref['test_result']} without the mesh", flush=True)
    assert mesh_test == ref["test_result"], (mesh_test, ref["test_result"])
    del ref
    torch.cuda.empty_cache()

    print("-- 10c: the dense pair's host batch path over the same mesh", flush=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_recbole_cdr(model="CMF", config_dict=mesh_config(mesh_host_config()),
                             saved=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["mesh_host"] = ops.launch_counts()
    hist = _report_run(result, wall, counts["mesh_host"], MESH_HOST_PATH)
    assert not dist.is_initialized(), "the run left its process group behind"
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    del result
    torch.cuda.empty_cache()

    print("== phase 14: the bf16 sparse catalog (B6's row-shard form) and the mapping "
          "models over the one-rank NCCL mesh", flush=True)
    t0 = time.perf_counter()
    b6_shapes = run_phase14_paths(dev, refs, counts)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"records": records, "b6_shapes": b6_shapes, "counts": counts}


def run_phase14_paths(dev, refs, counts):
    """Phase 14 (see the module's docstring): 14b, then 14a on 14b's first
    item-table step, then 14c. Keeps the runs' launch counts in ``counts``;
    returns the row-shard records of B6 and its plan by kernel and shape."""
    import torch
    import torch.distributed as dist

    import recbole_cdr_tpu_torch.trainer.trainer as trainer_module
    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    print("-- 14b: phase 9a's bf16 sparse catalog over the one-rank NCCL mesh", flush=True)
    calls = []
    real_b6 = trainer_module.sparse_adam

    def capture_b6(p, mu, nu, g_rows, ids, *args, **kwargs):  # the first step's two tables
        if len(calls) < 2:
            calls.append((p.shape, g_rows.clone(), ids.clone(), kwargs["row_offset"]))
        return real_b6(p, mu, nu, g_rows, ids, *args, **kwargs)

    trainer_module.sparse_adam = capture_b6
    rescans = k1_rescans(dev)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_recbole_cdr(model="CMF", config_dict=mesh_config(bf16_catalog_config()),
                                 saved=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer_module.sparse_adam = real_b6
    counts["mesh_bf16_catalog"] = c = ops.launch_counts()
    check_no_rescans(dev, rescans, "14b")
    hist = _report_run(result, wall, c, MESH_BF16_CATALOG_PATH)
    assert not dist.is_initialized(), "the run left its process group behind"
    assert len(hist) == CATALOG_EPOCHS and hist[-1]["loss"] < hist[0]["loss"], hist
    tiles = sum(-(-u // min(2048, u)) for u in
                [h["valid_users"] for h in hist] + [result["test_users"]])
    steps = sum(h["train_examples"] for h in hist) // (2 * BATCH)
    want = {"gather_dot_forward_bf16": steps, "gather_dot_backward_bf16": steps,
            "sparse_adam": 2 * steps, "group_rows": 2 * steps, "sharded_topk_local": tiles,
            "sharded_topk_merge": tiles}
    print(f"{steps} steps, {tiles} streaming tiles; launches {({k: c[k] for k in want})}, "
          f"expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)
    ref = refs["bf16_catalog"]
    for h, r in zip(hist, ref["epochs"]):
        print(f"  epoch {h['epoch']}: train {h['train_seconds']:.4f} s on the mesh, "
              f"{r['train_seconds']:.4f} s in 9a; validation {h['valid_seconds']:.4f} s, "
              f"{r['valid_seconds']:.4f} s; loss {h['loss']:.6f}, {r['loss']:.6f}", flush=True)
    check_mesh_losses([h["loss"] for h in hist], [r["loss"] for r in ref["epochs"]])
    recall = result["test_result"]["recall@10"]
    print(f"test recall@10 {recall} over the mesh, {ref['recall@10']} in 9a", flush=True)
    assert abs(recall - ref["recall@10"]) <= MESH_RECALL_TOL, (recall, ref["recall@10"])
    del result
    torch.cuda.empty_cache()

    print("-- 14a: B6's row-shard form on the item table's first step of 14b", flush=True)
    shape, g_rows, ids, offset = max(calls, key=lambda call: call[0][0])
    assert offset == 0, offset
    out = {"sparse_adam": {}, "group_rows": {}}
    check_b6_shards(dev, make_recorder(out), shape, g_rows, ids)
    time_occurrence_gather(dev, g_rows, ids)

    print("-- 14c: phase 8's DCDCSR and EMCDR over the one-rank NCCL mesh", flush=True)
    for name, model, schedule in MAPPING_RUNS[:2]:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_recbole_cdr(model=model,
                                 config_dict=mesh_config(mapping_config(model, schedule)),
                                 saved=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[f"mesh_{name}"] = c = ops.launch_counts()
        hist = _report_run(result, wall, c, MAPPING_PATHS[name])
        assert not dist.is_initialized(), "the run left its process group behind"
        check_mapping_run(model, schedule, result, hist, c)
        want = refs["mapping"][name]
        assert [h["phase"] for h in hist] == [p for p, _ in want["losses"]], hist
        check_mesh_losses([h["loss"] for h in hist], [loss for _, loss in want["losses"]])
        want = want["test"]
        print(f"test over the mesh {result['test_result']}, phase 8's {want}", flush=True)
        assert all(abs(result["test_result"][k] - v) <= MESH_MAPPING_TOL
                   for k, v in want.items()), (result["test_result"], want)
        del result
        torch.cuda.empty_cache()
    return {name: rec["shapes"] for name, rec in out.items()}


def check_mesh_losses(got, want):
    """Phase 14: a run's epoch losses over the one-rank mesh equal to the
    same run's without it: one rank does the same arithmetic, and every sum
    of K1, B6 and their plan runs in a fixed order."""
    print(f"  epoch losses {got} over the mesh, {want} without it", flush=True)
    assert got == want, (got, want)


def check_b6_shards(dev, record, shape, g_rows, ids):
    """Phase 14a: B6's row-shard form on ``ids`` (a step's global
    occurrences) and ``g_rows`` for a table of ``shape``, split into ``m``
    shards of ceil(N / m) rows for every m of ``B6_SHARDS``, the last padded:
    every shard, its plan built on the shard's kept scratch, against the
    plain version on CPU copies from the same random table and moments
    (``check_b6_plain``) and against a second run (bit-equal), untouched and
    pad rows unchanged; the last shard's update
    and plan timed into ``record`` under ``row shard m=<m>``, the update's
    library yardstick ``torch.optim.SparseAdam.step`` on the shard's own
    occurrences."""
    import torch

    from recbole_cdr_tpu_torch.ops import row_groups, sparse_adam as b6

    N, D = shape
    R = ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(146)
    step = b6.adam_step_size(1e-3, 0.9, 0.999, 5)
    ids_cpu, g_cpu = ids.cpu(), g_rows.cpu()
    for m in B6_SHARDS:
        L = -(-N // m)
        table = torch.zeros(L * m, D, device=dev)
        table[:N] = 0.1 * torch.randn(N, D, device=dev, generator=g)
        mu0 = 1e-3 * torch.randn(L * m, D, device=dev, generator=g)
        nu0 = 1e-6 * torch.rand(L * m, D, device=dev, generator=g)
        err = 0.0
        for j in range(m):
            off = j * L
            rows = slice(off, off + L)
            start = {"p": table[rows], "mu": mu0[rows], "nu": nu0[rows]}
            plan = row_groups.RowPlan(L, dev, off, R)
            runs = []
            for _ in range(2):
                state = tuple(t.clone() for t in start.values())
                groups = row_groups.group_rows(ids, plan)
                b6.sparse_adam(*state, g_rows, ids, step, groups=groups, row_offset=off)
                runs.append(state)
            plain = tuple(t.cpu() for t in start.values())
            b6.sparse_adam_plain(*plain, g_cpu, ids_cpu, step, 0.9, 0.999, 1e-8, off)
            check_plan(groups, ids, L, off)
            local = ids.long() - off
            local = local[(local >= 0) & (local < L)]
            untouched = torch.bincount(local, minlength=L) == 0
            for (name, before), got, again, want in zip(start.items(), *runs, plain):
                assert torch.equal(got, again), f"sparse_adam m={m} shard {j}: {name} differs"
                check_b6_plain(f"m={m} shard {j}: {name}", got, want)
                assert torch.equal(got[untouched], before[untouched]), \
                    f"sparse_adam m={m} shard {j}: {name} of an untouched row changed"
                err = max(err, float((got.cpu() - want).abs().max()))
            assert not plan.scratch[0].any(), "group_rows left its counters dirty"
        kern = runs[0]
        n_own, n_rows = (int(x) for x in groups.meta[:2])
        print(f"  sparse_adam row shards m={m}: the plan walks {R} occurrences, the update the "
              f"last shard's own (offset {off}, {L * m - N} pad rows): {n_own} of them in "
              f"{n_rows} rows; as the plain version (max_abs_err {err:.3g}), bit-equal run to "
              "run", flush=True)
        own = ids.long() - off
        own_mask = (own >= 0) & (own < L)
        tp = torch.nn.Parameter(table[rows].clone())
        topt = torch.optim.SparseAdam([tp], lr=1e-3)
        sparse_grad = torch.sparse_coo_tensor(own[own_mask][None], g_rows[own_mask], (L, D))
        plain_dev = tuple(t.clone() for t in start.values())

        def library():
            tp.grad = sparse_grad
            topt.step()

        record("sparse_adam",
               lambda: b6.sparse_adam(*kern, g_rows, ids, step, groups=groups, row_offset=off),
               lambda: b6.sparse_adam_plain(*plain_dev, g_rows, ids, step, 0.9, 0.999, 1e-8,
                                            off),
               err, 4 * n_own + n_own * D * 4 + 6 * n_rows * D * 4, n_rows * D * 12 + n_own * D,
               library_fn=library, shape=f"row shard m={m}")
        record("group_rows", lambda: row_groups.group_rows(ids, plan),
               lambda: row_groups.group_rows_plain(ids, L, off), 0.0,
               *plan_work(R, n_own, n_rows), library_fn=lambda: torch.sort(ids, stable=True),
               shape=f"row shard m={m}")
        del kern, runs, plain, plain_dev, start, tp, topt, table, mu0, nu0


def time_occurrence_gather(dev, g_rows, ids, reps=50):
    """Phase 14a: ``Mesh.gather_occurrences`` of one table's step over a
    one-rank NCCL group, on the host clock with the device synchronised per
    call (it waits for the slices' lengths), beside one synchronised empty
    step: the gather's own cost in the training loop."""
    import torch

    from recbole_cdr_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize_distributed(dev)
    try:
        mesh = make_mesh({"data": 1, "model": 1}, dev)
        for _ in range(5):
            mesh.gather_occurrences(ids, g_rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh.gather_occurrences(ids, g_rows)
            torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) / reps * 1e3
    finally:
        distributed.shutdown()
    print(f"  gather_occurrences of {ids.shape[0]} ids and [{g_rows.shape[0]}, "
          f"{g_rows.shape[1]}] rows over a one-rank NCCL group: {gather_ms:.4f} ms a call "
          f"(host clock, synchronised; a bare synchronise {sync_ms:.4f} ms)", flush=True)


def _run_tracking_passes(model, cfg, track):
    """``run_recbole_cdr(model, cfg)`` on the card, timed, its launch counts
    from a reset; with ``track``, each evaluation pass's (the run's peak so
    far, the allocation at the pass's start), the peak counted from the
    run's start. Returns (result, wall seconds, counts, passes); the run's
    trainer and test data are kept as ``result["trainer"]`` and
    ``result["test_data"]``."""
    import torch

    import recbole_cdr_tpu_torch.trainer.trainer as trainer_module
    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    real = trainer_module.CrossDomainTrainer._evaluate_batches
    real_evaluate = trainer_module.CrossDomainTrainer.evaluate
    before, kept = [], {}

    def keep(self, eval_data, *args, **kwargs):
        kept.update(trainer=self, test_data=eval_data)
        return real_evaluate(self, eval_data, *args, **kwargs)

    def own_peak(self, *args, **kwargs):
        """Each evaluation pass's own peak: the trainer records the peak since
        the last reset, so reset it at the pass's start, after keeping the
        run's peak so far (training's included) and what the run holds
        allocated as the pass starts."""
        before.append((torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        return real(self, *args, **kwargs)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if track:
        trainer_module.CrossDomainTrainer._evaluate_batches = own_peak
    trainer_module.CrossDomainTrainer.evaluate = keep
    t0 = time.perf_counter()
    try:
        result = run_recbole_cdr(model=model, config_dict=cfg, saved=True)
    finally:
        trainer_module.CrossDomainTrainer._evaluate_batches = real
        trainer_module.CrossDomainTrainer.evaluate = real_evaluate
    torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, ops.launch_counts()
    return {**result, **kept}, wall, counts, before


def first_tile_distinct(trainer, test_data):
    """The most distinct probabilities a row of the first fallback-sized
    test tile (users 1-32 against every item) holds under the trainer's
    compute type."""
    import torch

    users = torch.arange(1, 33, device="cuda")
    with torch.no_grad():
        scores = trainer._score_fn_for("OVERLAP", test_data)(users)
    return max(int(row.unique().numel()) for row in scores)


def evaluated_in_bf16(result):
    """The trained model of a float32 run evaluated as a bf16 run evaluates
    (the trainer's ``compute_dtype`` set to bfloat16 after training): (its
    test Recall@10, ``first_tile_distinct`` in bf16). Its launches come
    after the run's counts were taken and before the next run resets
    them."""
    import torch

    trainer, test_data = result["trainer"], result["test_data"]
    trainer.compute_dtype = getattr(torch, BF16)
    try:
        recall = trainer.evaluate(test_data, load_best_model=False)["recall@10"]
        distinct = first_tile_distinct(trainer, test_data)
    finally:
        trainer.compute_dtype = torch.float32
    return recall, distinct


def deepapf_trained_grid(result):
    """B16-bf16's grid on the trained model of phase 13's DeepAPF run: the
    first fallback-sized test tile (users 1-32 against every item) through
    the model's ``predict_grid`` on its bf16 copies, as the run's evaluation
    calls it, against ``deepapf_grid_plain`` on the same operands by
    ``close_prob16``; once on the trained tables, where at two epochs every
    bf16 probability may round to 0.5 and a wrong kernel could pass, and
    once with each table scaled to RMS ``GRID16_RMS``, where the
    probabilities spread and the controls (a constant 0.5, the float32 grid
    rounded at its output) must fail. Its launches come after the run's
    counts were taken."""
    import torch

    from recbole_cdr_tpu_torch.models import deepapf as deepapf_module
    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16
    from recbole_cdr_tpu_torch.utils.precision import call_with, cast_floats

    model, test_data = result["model"], result["test_data"]
    users = torch.arange(1, 33, device="cuda")
    items = torch.arange(test_data.item_num, device="cuda")
    dt = getattr(torch, BF16)
    tensors = {n: t.detach() for n, t in [*model.named_parameters(), *model.named_buffers()]}

    def grid(ts):
        return call_with(model, ts, model.predict_grid, users, items)

    for scaled in (False, True):
        ts = {n: t * (GRID16_RMS / t.pow(2).mean().sqrt())
              if scaled and n.endswith("_embedding") else t for n, t in tensors.items()}
        t16 = cast_floats(ts, dt)
        with torch.no_grad():
            got = grid(t16)
            deepapf_module.deepapf_grid = b16.deepapf_grid_plain
            try:
                want = grid(t16)
            finally:
                deepapf_module.deepapf_grid = b16.deepapf_grid
            controls = {"constant 0.5": torch.full_like(want, 0.5),
                        "float32 grid rounded at its output": grid(ts)} if scaled else {}
        close_prob16(got, want, "deepapf_grid_bf16 on the trained model's first test tile"
                     + (f", tables at RMS {GRID16_RMS}" if scaled else ""), controls)


def run_phase11_paths(counts, recalls, allocs):
    """Phase 11: the runs of ``PHASE11_RUNS``, each checked, their launch
    counts kept in ``counts`` and their test Recall@10 in ``recalls`` under
    the run's name, CoNet's validation passes' own allocations in
    ``allocs``."""
    for name, model, _ in PHASE11_RUNS:
        print(f"-- {name}: {model}, BOTH:{PHASE11_EPOCHS}, published widths", flush=True)
        result, wall, c, before = _run_tracking_passes(model, phase11_config(model),
                                                       name == "conet")
        counts[name] = c
        hist = _report_run(result, wall, c, PHASE11_PATHS[name])
        allocs[name] = check_phase11_run(name, result, hist, c, before)
        recalls[name] = result["test_result"]["recall@10"]
        if any(ref == name for _, _, ref in PHASE13_RUNS):
            recalls[name + "@bf16"] = evaluated_in_bf16(result)
            print(f"{model}'s trained model evaluated under bf16 compute: test Recall@10 "
                  f"{recalls[name + '@bf16'][0]:.4f}; at most {recalls[name + '@bf16'][1]} "
                  "distinct bf16 probabilities in a row of the first test tile", flush=True)
        del result


def conet_pass_allocs(model, hist, before):
    """CoNet's validation passes: what each allocates beyond what the run
    holds as it starts, printed with the pass's peak above parameters and
    moments, what the run holds as it starts and the run's peak before it;
    each within ``CONET_VALID_HEADROOM``. Returns the passes' own
    allocations."""
    state = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    peaks = [h["valid_peak_bytes"] for h in hist]
    held = [at_start for _, at_start in before[:len(hist)]]
    own = [p - a for p, a in zip(peaks, held)]
    mib = lambda xs: ", ".join(f"{x / 2 ** 20:.1f} MiB" for x in xs)  # noqa: E731
    print(f"CoNet parameters + moments {state / 2 ** 20:.1f} MiB; above them: each "
          f"validation pass's peak {mib(p - state for p in peaks)}, held as it starts "
          f"{mib(a - state for a in held)}, the run's peak before it (training "
          f"included) {mib(b - state for b, _ in before[:len(hist)])}; each pass's own "
          f"allocation {mib(own)} (limit {CONET_VALID_HEADROOM / 2 ** 20:.0f} MiB)",
          flush=True)
    assert all(a >= state for a in held) and all(0 < o < CONET_VALID_HEADROOM for o in own), \
        (state, held, peaks)
    return own


def check_phase11_run(name, result, hist, c, before):
    """Phase 11's checks of one run: BOTH epochs each validated with a
    falling loss; B16 once forward and once backward per step (both
    domains' pairs in one call), the plan of the backward's keys once per
    step, and its grid once per fallback tile; B15 and
    K4 once per dense tile; K2 and K3 twice per epoch (a stream per domain);
    for CoNet, what each validation pass allocates beyond what the run
    holds at its start (``before``: the run's peak so far and its
    allocation at each pass's start) within ``CONET_VALID_HEADROOM``; the
    pass's peak above parameters and moments (``valid_peak_bytes``) and the
    run's resident tensors are printed beside it."""
    E = PHASE11_EPOCHS
    assert [h["phase"] for h in hist] == ["BOTH"] * E, hist
    assert all("valid_seconds" in h for h in hist), hist
    assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
    examples = sum(h["train_examples"] for h in hist)
    assert examples % (2 * BATCH) == 0  # 2 domains x (4,096 positives + 4,096 negatives)
    steps = examples // (2 * BATCH)
    model = result["model"]
    n_target = model.target_num_items
    users = [h["valid_users"] for h in hist] + [result["test_users"]]
    if name == "deepapf":  # the predict fallback's tiles: FullSortEvalBatches.user_batch
        batch = lambda u: max(1, min(32, u), config_dict()["eval_batch_size"] // n_target)
        tiles = sum(-(-u // batch(u)) for u in users)
    else:
        tiles = sum(dense_tiles(u, n_target) for u in users)
    want = {"masked_topk": tiles, "neg_sampler": 2 * E, "swap_or_not": 2 * E}
    if name == "deepapf":
        want.update(deepapf_forward=steps, deepapf_backward=steps, group_rows=steps,
                    deepapf_grid=tiles)
    if name == "conet":
        want.update(conet_tower=tiles)
    print(f"{steps} training steps, {len(users)} evaluation passes of {tiles} tiles; launches "
          f"{ {k: c[k] for k in want} }, expected {want}", flush=True)
    assert all(c[k] == v for k, v in want.items()), (c, want)
    if name == "conet":
        return conet_pass_allocs(model, hist, before)
    return None


def run_phase12_paths(counts, recalls):
    """Phase 12: BiTGCF, NATR and DTCDR DMF with the configurations of their
    float32 runs (phases 5, 6 and 7b) under ``compute_dtype: bfloat16``.
    Each must launch, for every kernel of its float32 run, that kernel's
    16-bit form (``BF16_FORMS``) where it has one and else the kernel itself,
    exactly as many times as the float32 run did, and no other kernel (the
    float32 B8, B9 and B11 never); every phase's loss falls; the test
    Recall@10 lies within ``PHASE12_RECALL_TOL`` of the float32 run's."""
    import torch

    from recbole_cdr_tpu_torch import ops, run_recbole_cdr

    for name, model, ref in PHASE12_RUNS:
        print(f"-- {name}: {model} as {ref}, compute_dtype bfloat16", flush=True)
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_recbole_cdr(model=model, config_dict=phase12_config(ref), saved=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = c = ops.launch_counts()
        want = {BF16_FORMS.get(k, k): n for k, n in counts[ref].items() if n}
        hist = _report_run(result, wall, c, tuple(want))
        assert [h["phase"] for h in hist] == [h["phase"] for h in result["history"]]
        for phase in dict.fromkeys(h["phase"] for h in hist):
            losses = [h["loss"] for h in hist if h["phase"] == phase]
            assert len(losses) > 1 and losses[-1] < losses[0], (phase, losses)
        print(f"launches {want}, as the float32 run's of their float32 forms", flush=True)
        assert {k: c[k] for k in want} == want, (c, want)
        assert all(p.dtype == torch.float32 for p in result["model"].parameters())
        got, ref_recall = result["test_result"]["recall@10"], recalls[ref]
        absolute, relative = PHASE12_RECALL_TOL
        print(f"test Recall@10: bf16 {got:.4f}, float32 {ref_recall:.4f} (tolerance "
              f"{max(absolute, relative * ref_recall):.4f})", flush=True)
        assert abs(got - ref_recall) <= max(absolute, relative * ref_recall), (got, ref_recall)
        del result


def run_phase13_paths(counts, recalls, allocs):
    """Phase 13: DeepAPF and CoNet with phase 11's configurations under
    ``compute_dtype: bfloat16``. Each must launch, for every kernel of its
    float32 run, that kernel's 16-bit form (``BF16_FORMS``: B16's and B15's)
    where it has one and else the kernel itself, exactly as many times as
    the float32 run did, and no other kernel (the float32 B15 and B16
    never); the loss falls; the test Recall@10 lies within
    ``PHASE12_RECALL_TOL`` of the float32 run's trained model evaluated
    under bf16 (``evaluated_in_bf16``: the effect of training in bf16), and
    of the float32 run's own wherever the bf16 run's own probabilities
    resolve a ranking (``first_tile_distinct``): where every probability of
    a test row rounds to one bf16 value (DeepAPF at phase 11's two epochs:
    all of them 0.5), the evaluator ranks by K4's tie order, lax.top_k's
    (lower id first), as JAX's bf16 evaluation does, and that comparison
    says nothing of the kernels; it is printed, not held, and B16-bf16's
    grid is held on the run's trained model instead (``deepapf_trained_grid``).
    CoNet's validation passes' own allocations are printed beside phase 11's
    and held to its limit."""
    import torch

    for name, model, ref in PHASE13_RUNS:
        print(f"-- {name}: {model} as {ref}, compute_dtype bfloat16", flush=True)
        result, wall, c, before = _run_tracking_passes(model, phase13_config(model),
                                                       ref == "conet")
        counts[name] = c
        want = {BF16_FORMS.get(k, k): n for k, n in counts[ref].items() if n}
        hist = _report_run(result, wall, c, tuple(want))
        losses = [h["loss"] for h in hist]
        assert [h["phase"] for h in hist] == ["BOTH"] * PHASE11_EPOCHS, hist
        assert losses[-1] < losses[0], losses
        print(f"launches {want}, as the float32 run's of their float32 forms", flush=True)
        assert {k: c[k] for k in want} == want, (c, want)
        assert all(p.dtype == torch.float32 for p in result["model"].parameters())
        got, ref_recall = result["test_result"]["recall@10"], recalls[ref]
        at16, _ = recalls[ref + "@bf16"]
        distinct = first_tile_distinct(result["trainer"], result["test_data"])
        absolute, relative = PHASE12_RECALL_TOL
        tol = lambda r: max(absolute, relative * r)  # noqa: E731
        print(f"test Recall@10: bf16 {got:.4f} (at most {distinct} distinct bf16 probabilities "
              f"a row of its first test tile); the float32 run's {ref_recall:.4f} (tolerance "
              f"{tol(ref_recall):.4f}), its trained model evaluated under bf16 {at16:.4f} "
              f"(tolerance {tol(at16):.4f})", flush=True)
        assert abs(got - at16) <= tol(at16), (got, at16)
        if distinct > 1:
            assert abs(got - ref_recall) <= tol(ref_recall), (got, ref_recall)
        else:
            print("  every bf16 probability of a test row is one value: the bf16 ranking is "
                  "K4's tie order, so the float32 run's Recall@10 is not held", flush=True)
        if ref == "deepapf":
            deepapf_trained_grid(result)
        if ref == "conet":
            own = conet_pass_allocs(result["model"], hist, before)
            print("CoNet validation passes' own allocation: bf16 " + ", ".join(
                f"{x / 2 ** 20:.1f}" for x in own) + " MiB, float32 (phase 11) " + ", ".join(
                f"{x / 2 ** 20:.1f}" for x in allocs[ref]) + " MiB", flush=True)
        del result


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
