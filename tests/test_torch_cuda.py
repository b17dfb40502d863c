"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the edge cases the main path's shapes do not reach: ``masked_topk`` with
k up to 64 and every branch of its launch plan (a row split over a
thread-block cluster, eight rows a block, wide history bitmaps), run to run,
fewer unmasked items than k, B3's epoch streams (one key row or one a
source cycle, many key rows a block, segments past step 0, n below a step,
n of 1 and 0, the OVERLAP stream, the catalog's, several blocks an SM),
history widths with and without 16-byte loads, embedding widths that are
not a multiple of the warp; every ``streaming_topk`` template at the
catalog's 1,100,001 items, a history row spanning many item ranges and
user blocks smaller than the kernel's row block; K1's backward in its three
forms (grouped, positions, a broken promise of positions) and ``sparse_adam``
(every id on one row, more ids than rows, odd widths, row shards) bit-equal
to their plain versions on CPU copies and run to run, the plan of a step's
ids (``group_rows``) and the row-sharded lookup's backward (``row_sum``); ``rank_sum`` with ties
everywhere, history, masked positives, rows without positives and rows
longer than its shared-memory chunk, at shapes reaching every branch of its
launch plan (a row over a thread-block cluster, one block a row), 1,600
positives in a row, the candidate form at its shared-memory limit; the NATR
attention's training forward and backward (from the anchor table, one
anchor stage per distinct anchor, a popular anchor at every eighth pair;
the table's gradient zero on untouched rows, reruns bit-equal alone and
from the forward's kept values) and full-sort forms at every kernel width,
with empty and single-slot histories, in both overlap modes; ``streaming_topk``'s tensor-core edges
(D of 8 to 256, k of 1 to 64, partial row blocks and item tiles, a row
masked down to k items); the anchor table and the pair grid at every
kernel width; DTCDR's rating-vector product (B11) with empty rows, rows of
many pieces, repeated ids, every id the same and widths above one
128-column slice, both directions bit-equal over two runs and one plan
serving two tables and both directions; the candidate top-k (B10) and the
candidate form of ``rank_sum`` with fewer candidates than k, fully padded
rows and ties; the streaming evaluator's metrics against the dense path's
for CMF on real-valued factors. Plus the entry point on the card, on the
dense path, on the catalog path (sparse optimizer, streaming evaluation),
for BiTGCF, for NATR with GAUC, for DTCDR in the candidate and labeled
eval modes, and for DCDCSR, EMCDR (both forms) and SSCDR. DCDCSR's benchmark
top-k (B12) at every list width (k of 1 to 32), D not a multiple of 4 and
above one 64-column chunk, fewer overlapped rows than one staged tile, more
column splits than the card needs, all-zero rows (ties: ids 0..k-1) and NaN
where ``sn + t_pop`` is 0, and two runs bit-equal. The bf16 forms: B13
against its plain version (bf16 and float16 factors, widths through the
element-wise staging path) and against B5 on the upcast operands, its
wgmma / TMA tile kernel at the edges of its launch plan, B2a
bit-exact, K1-bf16 forward and backward; and the entry point on the
catalog path in bf16 and with popularity negatives on both streams. B14,
the mesh-sharded streaming top-k (its local stage at each shard's offset,
then its merge), against its plain version and one B5 (or B13) call over
the whole table, pad rows past the items included, and the merge alone at
1 to 8 lists of k 1, 17, 50 and 64 with ties and padding; and CMF over a one-rank
NCCL mesh through the entry point. B16, DeepAPF's attention-gated score
(forward and backward from the five tables and both domains' ids, and the
grid) at every kernel width, partial tiles, masked entities and the
overlapped count's boundary, the grid's 2-D tiles ragged in
both directions with every entity masked or none, in float32 and float16; B15, CoNet's tower, at the
published tower, widths padded to a multiple of 4, a one-layer tower and
the largest (weights staged layer by layer), a saturating call; both
refusing what the kernels do not take; and CLFM, DeepAPF and CoNet through
the entry point. The 16-bit forms of B8 (light and heavy rows, D 32 / 64 /
128, dropout on and off), B9 (training forward and backward, anchor table
and pair grid, both overlap modes, D 32 / 64 / 128), B11, B16 (forward,
backward and grid, D 32 / 64 / 128, both entity sides, the float16 masked
logit that JAX's -1e31 makes -inf) and B15 (the published tower at a dense
tile, padded widths, the largest tower) against their plain versions in
bfloat16 and float16, two runs bit-equal where no atomics add; and
BiTGCF, NATR, DTCDR's DMF, CoNet and DeepAPF under bf16 compute through the
entry point.

Marked ``cuda``; without a card every test skips. On the card (where jax is
not installed, so the repository's conftest cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from recbole_cdr_tpu_torch import ops
from recbole_cdr_tpu_torch.ops import benchmark_topk as b12
from recbole_cdr_tpu_torch.ops import candidate_topk as b10
from recbole_cdr_tpu_torch.ops import conet_tower as b15
from recbole_cdr_tpu_torch.ops import deepapf_attention as b16
from recbole_cdr_tpu_torch.ops import gather_dot as k1
from recbole_cdr_tpu_torch.ops import graph_layer as b8
from recbole_cdr_tpu_torch.ops import masked_topk as k4
from recbole_cdr_tpu_torch.ops import natr_attention as b9
from recbole_cdr_tpu_torch.ops import neg_sampler as k2
from recbole_cdr_tpu_torch.ops import rank_sum as b7
from recbole_cdr_tpu_torch.ops import rating_vector as b11
from recbole_cdr_tpu_torch.ops import row_groups
from recbole_cdr_tpu_torch.ops import shuffle as k3
from recbole_cdr_tpu_torch.ops import sparse_adam as b6
from recbole_cdr_tpu_torch.ops import topk as b5

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _ints(lo, hi, shape, gen):
    return torch.randint(lo, hi, shape, dtype=torch.int32, device="cuda", generator=gen)


@pytest.mark.parametrize("B,I,k", [(64, 5001, 10), (33, 700, 32), (17, 300, 50),
                                   (8, 600_000, 10), (5, 12, 10),
                                   # every branch of masked_topk_plan: a row a cluster
                                   # (B <= 4 rows per SM), 8 rows a block, wide bitmaps
                                   (1, 4980, 64), (25, 4980, 10), (32, 4980, 10),
                                   (33, 4981, 64), (2048, 4980, 10), (2048, 4980, 64),
                                   (600, 1_000_000, 10)])
def test_masked_topk_matches_plain(gen, B, I, k):
    scores = torch.round(torch.randn(B, I, device="cuda", generator=gen) * 4) / 4  # ties
    counts = torch.randint(0, min(40, I), (B,), device="cuda", generator=gen)
    counts[0] = I - 3  # fewer than k unmasked items: masked ties decide
    row_ptr = torch.zeros(B + 1, dtype=torch.int32, device="cuda")
    row_ptr[1:] = torch.cumsum(counts, 0)
    items = torch.cat([torch.randperm(I, device="cuda", generator=gen)[:c]
                       for c in counts.tolist()]).to(torch.int32)
    got = k4.masked_topk(scores, row_ptr, items, k)
    torch.cuda.synchronize()
    assert torch.equal(got, k4.masked_topk_plain(scores, row_ptr, items, k))
    assert torch.equal(got, k4.masked_topk(scores, row_ptr, items, k))  # run to run


#: B3's streams: (step_lo, n_steps, dstep, n, batches a source cycle or 0,
#: the table's columns: 2, a domain's users and items; 1, the overlapped
#: ids). One key row, or one a cycle (a cycle of one step: a key row a
#: step, 70,000 rows at dstep 3, many rows a block); the source stream of
#: the dense path (19 steps of 4,096, one cycle of 147 steps); segments that
#: start past step 0; n below one step, n of 1 and 0; the OVERLAP stream (one
#: table of overlapped ids); the catalog's 482 steps of 16,384 (several
#: blocks an SM)
STREAMS = [(0, 49, 4096, 200_000, 0, 2), (0, 49, 4096, 150_000, 1, 2), (0, 3, 5, 1, 0, 2),
           (0, 70_000, 3, 1000, 1, 2), (0, 19, 4096, 600_000, 147, 2),
           (0, 49, 4096, 150_000, 10, 2), (7, 12, 4096, 100_000, 0, 2),
           (7, 12, 4096, 100_000, 5, 2), (0, 2, 4096, 1000, 0, 2), (0, 3, 8, 1, 1, 2),
           (0, 2, 8, 0, 0, 2), (0, 21, 100, 2000, 0, 1), (3, 5, 100, 2000, 0, 1),
           (0, 482, 16_384, 2_400_000, 0, 2)]


@pytest.mark.parametrize("step_lo,n_steps,dstep,n,per_cycle,cols", STREAMS)
def test_swap_or_not_matches_plain(gen, step_lo, n_steps, dstep, n, per_cycle, cols):
    """B3's one launch a stream against its plain version on the same card
    tensors, bit for bit: each column of the table at the permuted rows and
    the weights; a second launch equal."""
    K = -(-(step_lo + n_steps) // per_cycle) if per_cycle else 1
    keys = _ints(0, max(n, 1), (K, 64), gen)
    salts = _ints(-2 ** 31, 2 ** 31, (K, 64), gen)
    table = _ints(0, 1 << 30, (max(n, 1), 2) if cols == 2 else (max(n, 1),), gen)
    ops.reset_launch_counts()
    got = k3.swap_or_not(table, n, keys, salts, step_lo, n_steps, dstep, per_cycle)
    torch.cuda.synchronize()
    assert ops.launch_counts()["swap_or_not"] == 1
    want = k3.swap_or_not_stream_plain(table, n, keys, salts, step_lo, n_steps, dstep,
                                       per_cycle)
    assert len(got) == cols + 1 and all(torch.equal(a, b) for a, b in zip(got, want))
    again = k3.swap_or_not(table, n, keys, salts, step_lo, n_steps, dstep, per_cycle)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _sorted_lists(m, B, k, gen, span=1000):
    """[m, B, k] lists as B14's local stage writes them, on the card: scores
    in {-3..3} (exact ties everywhere), list l's ids in [l span, (l + 1)
    span), each row sorted by (score desc, id asc); every third row of a
    list keeps only its first (row mod (k + 1)) entries, padded with (-inf,
    INT32_MAX)."""
    s = torch.randint(-3, 4, (m, B, k), device="cuda", generator=gen).float()
    ids = torch.rand(m, B, span, device="cuda", generator=gen).argsort(-1)[..., :k]
    ids = (ids + span * torch.arange(m, device="cuda")[:, None, None]).to(torch.int32)
    key = -s * (span * m) + ids  # (score desc, id asc), exact in float32 at these sizes
    order = key.argsort(-1)
    s, ids = s.gather(-1, order), ids.gather(-1, order)
    rows = torch.arange(B, device="cuda")
    keep = torch.where(rows % 3 == 0, rows % (k + 1), k)[None, :, None]
    pad = torch.arange(k, device="cuda")[None, None, :] >= keep
    return s.masked_fill(pad, -torch.inf), ids.masked_fill(pad, b5.INT32_MAX)


@pytest.mark.parametrize("k", [1, 17, 50, 64])
@pytest.mark.parametrize("m", range(1, 9))
def test_sharded_topk_merge_matches_plain(gen, m, k):
    """B14's merge (every candidate placed by its rank) against
    ``sharded_topk_merge_plain`` on sorted lists with exact ties across and
    within lists and padded rows, bit for bit; one launch a call."""
    cs, ci = _sorted_lists(m, 300, k, gen)
    ops.reset_launch_counts()
    got = b5.sharded_topk_merge(cs, ci, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sharded_topk_merge"] == 1
    want = b5.sharded_topk_merge_plain(cs, ci, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _history_rows(n_users, H, sentinel, gen, rows):
    """(hist int32 [n_users, H], lens or None) for the sampler's card tests.
    "full": random ids below ``sentinel`` in every entry, no lens. "padded":
    the device loop's rows, each user's live entries (random ids below the
    sentinel, most rows short, a few over the warp's walk, user 0 at the
    full width H) first and the sentinel after them. "junk": the same live
    entries and random ids below the sentinel past them, which the kernel
    must ignore."""
    hist = _ints(0, sentinel, (n_users, H), gen)
    if rows == "full":
        return hist, None
    lens = torch.minimum(_ints(0, 40, (n_users,), gen) * _ints(1, 4, (n_users,), gen) ** 3,
                         torch.tensor(H, device="cuda")).to(torch.int32)
    lens[0] = H
    past = torch.arange(H, device="cuda")[None, :] >= lens[:, None]
    if rows == "padded":
        hist = torch.where(past, sentinel, hist).to(torch.int32)
    return hist, lens


@pytest.mark.parametrize("H,ranges,neg_num,rows", [
    (400, ((1, 2000), (5000, 6000)), 1, "full"), (37, ((1, 30),), 2, "full"),
    (250, ((7, 5000),), 1, "full"), (2048, ((1, 2000), (5000, 6000)), 1, "padded"),
    (2048, ((7, 5000),), 2, "junk"), (402, ((1, 30),), 1, "junk")])
def test_neg_sampler_matches_plain(gen, H, ranges, neg_num, rows):
    """B2 bit-exact against its plain version: whole rows, the device loop's
    sentinel-padded rows with their live lengths (one user at the 2,048
    cap), and rows with junk past their live lengths."""
    n_users = 4000
    hi = ranges[-1][0] + ranges[-1][1]
    hist, lens = _history_rows(n_users, H, hi, gen, rows)
    uids = _ints(0, n_users, (30_000,), gen)
    uids[:64] = 0
    base = _ints(-2 ** 31, 2 ** 31, (30_000 * neg_num,), gen)
    got = k2.sample_negatives(base, uids, hist, ranges, neg_num, lens)
    torch.cuda.synchronize()
    want = k2.sample_negatives_plain(base, uids, hist, ranges, neg_num, lens=lens)
    assert torch.equal(got, want)
    if rows == "padded":  # the sentinels never match: the whole rows give the same
        assert torch.equal(got, k2.sample_negatives(base, uids, hist, ranges, neg_num))


def _k1_case(form, D, dtype, gen):
    """K1's operands for one backward form: ``grouped``, random ids into
    whole tables (the plan of each); ``positions``, sub-tables read by
    position (the user table's rows shared by two pairs each, BPR's user
    slot); ``broken``, tables marked as read by position whose random ids
    break that (the kernel recomputes them)."""
    P = 20_000
    Nu, Ni = {"grouped": (3000, 900), "positions": (P // 2, P), "broken": (4000, 2000)}[form]
    U = torch.randn(Nu, D, device="cuda", generator=gen).to(dtype)
    I = torch.randn(Ni, D, device="cuda", generator=gen).to(dtype)
    if form == "positions":
        u = (torch.arange(P, device="cuda") % Nu).int()
        i = torch.arange(P, device="cuda", dtype=torch.int32)
    else:
        u, i = _ints(0, Nu, (P,), gen), _ints(0, Ni, (P,), gen)
    g = torch.randn(P, device="cuda", generator=gen).to(dtype)
    positions = (form != "grouped",) * 2
    return U, I, u, i, g, positions


@pytest.mark.parametrize("form", ["grouped", "positions", "broken"])
@pytest.mark.parametrize("D", [64, 48, 100])
def test_gather_dot_matches_plain(gen, D, form):
    """Scores within tolerance of the plain version (another summation
    order); the backward in every form ``torch.equal`` to the plain version
    on CPU copies (each row's terms added in position order, as index_add_
    adds them there) and to a second run."""
    U, I, u, i, g, positions = _k1_case(form, D, torch.float32, gen)
    s = k1.gather_dot_forward(U, I, u, i)
    torch.testing.assert_close(s, k1.gather_dot_plain(U, I, u, i), rtol=1e-5, atol=1e-4)
    assert torch.equal(s, k1.gather_dot_forward(U, I, u, i))
    rescans = k1.positions_rescans("cuda")
    runs = [k1.gather_dot_backward(U, I, u, i, g, k1.backward_groups(U, I, u, i, positions))
            for _ in range(2)]
    # a broken promise is recomputed, and counted, once a launch
    assert k1.positions_rescans("cuda") == rescans + 2 * (form == "broken")
    want = k1.gather_dot_backward_plain(*(t.cpu() for t in (U, I, u, i, g)))
    for got, again, ref in zip(*runs, want):
        assert torch.equal(got, again) and torch.equal(got.cpu(), ref)


def _csr(hist):
    row_ptr = torch.zeros(len(hist) + 1, dtype=torch.int32, device="cuda")
    row_ptr[1:] = torch.cumsum(torch.tensor([len(h) for h in hist], device="cuda"), 0)
    return row_ptr, torch.cat(hist).to(torch.int32)


@pytest.mark.parametrize("B,I,D,k", [(40, 1_100_001, 64, 10), (5, 1_100_001, 64, 64),
                                     (33, 20_000, 64, 32), (70, 9000, 17, 16), (3, 70, 8, 64)])
def test_streaming_topk_matches_plain(gen, B, I, D, k):
    """Integer-valued factors: every score is exact whatever the sum order,
    ties are everywhere, and the ids must equal the plain version's. Row 0's
    history spans many item tiles and ranges; row 1 masks all but 3
    items, so masked ties decide its top-k."""
    U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).float()
    T = torch.randint(-3, 4, (I, D), device="cuda", generator=gen).float()
    hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
            for c in torch.randint(0, 50, (B,), generator=torch.Generator().manual_seed(B))]
    hist[0] = torch.randperm(I, device="cuda", generator=gen)[:min(I - 1, 20_000)]
    if B > 1:
        hist[1] = torch.randperm(I, device="cuda", generator=gen)[:I - 3]
    row_ptr, items = _csr(hist)
    got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
    torch.cuda.synchronize()
    want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s, want_s)


def test_streaming_topk_float_scores_within_tolerance(gen):
    """Normal factors: the kernel and torch.matmul add in different orders,
    so scores agree within 1e-4 and ids wherever neighbours differ by more."""
    U = torch.randn(64, 64, device="cuda", generator=gen)
    T = torch.randn(300_001, 64, device="cuda", generator=gen)
    row_ptr, items = _csr([torch.randperm(300_001, device="cuda", generator=gen)[:30]
                           for _ in range(64)])
    got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, 10)
    want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, 10)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-4)
    gap = torch.diff(want_s, dim=1).abs()
    clear = torch.ones_like(want_i, dtype=torch.bool)
    clear[:, 1:] &= gap > 1e-4
    clear[:, :-1] &= gap > 1e-4
    assert torch.equal(got_i[clear], want_i[clear])


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("D", [8, 17, 32, 128, 256])
def test_streaming_topk_tensor_core_edges(gen, D, k):
    """The tensor-core kernel's edges, at 70 rows (not a multiple of its
    64-row block): an item axis smaller than one 128-item tile and one of
    313 tiles whose last is partial; row 2 masked down to exactly k items;
    row 3's history inside the last, partial tile. Integer-valued factors
    score exactly, so ids and scores equal the plain version's; normal
    factors score within 1e-4 + 1e-5 |s| (chip_smoke.py's B5_TOL), their
    ids equal wherever neighbouring scores differ by more."""
    B = 70
    for I in (100, 40_001):
        hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
                for c in torch.randint(0, 30, (B,), generator=torch.Generator().manual_seed(D))]
        hist[2] = torch.randperm(I - 1, device="cuda", generator=gen)[:I - 1 - k] + 1
        last = I - I % 128 if I % 128 else I - 128
        hist[3] = torch.arange(max(last, 1), I, 2, device="cuda")
        row_ptr, items = _csr(hist)
        U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).float()
        T = torch.randint(-3, 4, (I, D), device="cuda", generator=gen).float()
        got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
        torch.cuda.synchronize()
        want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
        assert torch.equal(got_i, want_i), (I, D, k)
        assert torch.equal(got_s, want_s), (I, D, k)
        assert bool((got_s[2] > torch.finfo(torch.float32).min).all())  # its k unmasked items
        U, T = torch.randn(B, D, device="cuda", generator=gen), torch.randn(I, D, device="cuda", generator=gen)
        got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
        want_s, want_i = b5.streaming_topk_plain(U, T, row_ptr, items, k)
        tol = 1e-4 + 1e-5 * want_s.abs()
        assert bool(((got_s - want_s).abs() <= tol).all()), (I, D, k)
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        clear = torch.ones_like(want_i, dtype=torch.bool)
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        assert torch.equal(got_i[clear], want_i[clear]), (I, D, k)


def _b6_steps(p, mu, nu, steps, offset=0):
    """``steps`` (ids, gradient rows, step size) through the kernel, the
    grouping built on one kept plan, and through the plain version on CPU
    copies; returns the plain version's (p, mu, nu)."""
    plan = row_groups.RowPlan(p.shape[0], "cuda", offset)
    ref = [t.cpu() for t in (p, mu, nu)]
    for ids, g, step in steps:
        groups = row_groups.group_rows(ids, plan)
        b6.sparse_adam(p, mu, nu, g, ids, step, groups=groups, row_offset=offset)
        b6.sparse_adam_plain(*ref, g.cpu(), ids.cpu(), step, 0.9, 0.999, 1e-8, offset)
    torch.cuda.synchronize()
    assert not plan.scratch[0].any()  # the counters are left ready
    return ref


@pytest.mark.parametrize("N,D,R,kind", [(1_400_000, 64, 32_768, "random"), (1000, 64, 5000, "random"),
                                         (300, 33, 4096, "one_row"), (77, 65, 200, "random"),
                                         (1000, 1, 999, "unique")])
def test_sparse_adam_matches_plain(gen, N, D, R, kind):
    """Three steps on one kept scratch, random normal gradients: p, mu and
    nu ``torch.equal`` to the plain version on CPU copies (each row's
    gradient rows added in position order, as index_add_ adds them there),
    every row touched up to 4,096 times included, and to a second run."""
    start = torch.randn(N, D, device="cuda", generator=gen)
    steps = []
    for c in range(1, 4):
        ids = {"random": lambda: _ints(0, N, (R,), gen),
               "one_row": lambda: torch.full((R,), 7, dtype=torch.int32, device="cuda"),
               "unique": lambda: torch.randperm(N, device="cuda", generator=gen)[:R].int()}[kind]()
        steps.append((ids, torch.randn(R, D, device="cuda", generator=gen),
                      b6.adam_step_size(1e-3, 0.9, 0.999, c)))
    runs = []
    for _ in range(2):
        state = (start.clone(), torch.zeros_like(start), torch.zeros_like(start))
        ref = _b6_steps(*state, steps)
        runs.append(state)
    for got, again, want in zip(*runs, ref):
        assert torch.equal(got, again) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("N,D,m", [(1000, 64, 2), (1000, 33, 3), (77, 65, 4), (1000, 64, 1)])
def test_sparse_adam_row_shards_match_plain(gen, N, D, m):
    """B6's row-shard form: every shard of ceil(N / m) rows (the last
    padded) at its offset, two steps on the global occurrences of the step
    (every shard's rows, duplicates across them, and ``OCCURRENCE_PAD``
    padding, which every shard skips): ``torch.equal`` to the plain version
    on CPU copies and to a second run, the pad rows untouched."""
    from recbole_cdr_tpu_torch.parallel.mesh import OCCURRENCE_PAD

    L = -(-N // m)
    R = 6 * N
    start = torch.zeros(L * m, D, device="cuda")
    start[:N] = torch.randn(N, D, device="cuda", generator=gen)
    steps = []
    for c in range(1, 3):
        ids = _ints(0, N, (R,), gen)
        ids[::7] = OCCURRENCE_PAD
        steps.append((ids, torch.randn(R, D, device="cuda", generator=gen),
                      b6.adam_step_size(1e-3, 0.9, 0.999, c)))
    for j in range(m):
        off = j * L
        runs = []
        for _ in range(2):
            state = (start[off:off + L].clone(), torch.zeros(L, D, device="cuda"),
                     torch.zeros(L, D, device="cuda"))
            ref = _b6_steps(*state, steps, off)
            runs.append(state)
        for got, again, want in zip(*runs, ref):
            assert torch.equal(got, again) and torch.equal(got.cpu(), want)
        assert torch.equal(runs[0][0][N - off:], start[N:off + L])  # the padding


@pytest.mark.parametrize("case", ["empty", "distinct", "every_other", "outside",
                                  "popular", "catalog", "beyond_inboxes"])
def test_group_rows_matches_plain(gen, case):
    """The plan against its plain version on CPU copies, heads compared in
    row order (the card's come in no set order): empty ids, all distinct,
    one id at every other position, ids outside the shard (and the mesh's
    padding), one row at 6,000 positions among random ones, a catalog
    step's 16,384 ids over 1.1M rows (these by the sorted inboxes), and
    40,000 ids, 20,000 of them one row (by the four rounds; the shorter last
    step by the inboxes on the same kept plan); the same heads listed as
    big; each time a second set in the same launch, on one kept plan a
    table's, which is left zero: twice, then a shorter last step (R below
    the plan's capacity, its fields at the capacity's stride)."""
    from recbole_cdr_tpu_torch.parallel.mesh import OCCURRENCE_PAD

    L, off = {"outside": (500, 1000), "catalog": (1_100_001, 0)}.get(case, (3000, 0))
    R = {"empty": 0, "distinct": 2500, "catalog": 16_384, "beyond_inboxes": 40_000}.get(
        case, 12_000)
    if case == "distinct":
        ids = torch.randperm(L, device="cuda", generator=gen)[:R].int()
    elif case == "outside":
        ids = _ints(0, 2000, (R,), gen)
        ids[::5] = OCCURRENCE_PAD
    else:
        ids = _ints(0, L, (R,), gen)
        if case == "every_other":
            ids[::2] = 17
        if case in ("popular", "beyond_inboxes"):
            ids[torch.randperm(R, device="cuda", generator=gen)[:R // 2]] = 5
    other = _ints(0, 700, (9000,), gen)
    plan, plan2 = row_groups.RowPlan(L, "cuda", off), row_groups.RowPlan(700, "cuda")
    for step in (ids, ids, ids[:R // 3]):
        got, got2 = row_groups.group_rows(step, plan, second=(other, plan2))
        assert got.stride == plan.capacity >= got.R == step.shape[0]
        for grp, want in ((got, row_groups.group_rows_plain(step.cpu(), L, off)),
                          (got2, row_groups.group_rows_plain(other.cpu(), 700))):
            assert torch.equal(grp.meta[:3].cpu(), want.meta[:3])
            for a, b in zip(row_groups.canonical(grp), row_groups.canonical(want)):
                assert torch.equal(a, b)
            H, n_big = int(want.meta[1]), int(want.meta[2])
            rows = grp.head_row[:H].long()
            assert torch.equal(grp.head_row[grp.row_head[rows].long()], grp.head_row[:H])
            assert torch.equal(*(torch.sort(g.head_row[g.big[:n_big].long()].cpu()).values
                                 for g in (grp, want)))
    assert not plan.scratch[0].any() and not plan2.scratch[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 33])
def test_row_sum_matches_plain(gen, D, dtype):
    """The row-sharded lookup's backward: each shard's rows of a step's
    gradient rows (ids across every shard, duplicates) ``torch.equal`` to
    the plain version on CPU copies and to a second run; rows no id names
    are 0."""
    N, m, P = 5000, 3, 40_000
    L = -(-N // m)
    ids = _ints(0, N, (P,), gen)
    src = torch.randn(P, D, device="cuda", generator=gen).to(dtype)
    for j in range(m):
        plan = row_groups.RowPlan(L, "cuda", j * L)
        runs = [row_groups.row_sum(src, ids, row_groups.group_rows(ids, plan)) for _ in range(2)]
        want = row_groups.row_sum_plain(src.cpu(), row_groups.group_rows_plain(ids.cpu(), L, j * L),
                                        ids.cpu())
        assert runs[0].dtype == dtype
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0].cpu(), want)


#: the heavy rows 2 and 3 (and columns 2 and 3) of ``_random_csr``: how
#: many nonzeros each gets beyond the random ones
HEAVY_ROWS = {"mixed": (65, 5000), "long": (65, 20_001), "light": (0, 0)}


def _random_csr(N, nnz, gen, rows="mixed"):
    """A random non-symmetric [N, N] CSR and its transpose's CSR: row 0 has
    no nonzero, row 1 (and column 1) exactly one, rows 2 and 3 (and columns
    2 and 3) ``HEAVY_ROWS[rows]`` more than the rest ("mixed": 64 + 1 and
    5,000, so that the kernel splits them into several pieces; "long": a
    row over 20,000; "light": none, every row one piece at the tests'
    densities); duplicates allowed."""
    n2, n3 = HEAVY_ROWS[rows]
    rows = _ints(0, N, (nnz,), gen).long()
    cols = _ints(0, N, (nnz,), gen).long()
    if N > 3:
        keep = (rows != 0) & (rows != 1) & (cols != 1)
        extra = [torch.full((n,), r, device="cuda") for r, n in ((2, n2), (3, n3))]
        extra_cols = _ints(4, N, (n2 + n3,), gen).long()
        rows = torch.cat([rows[keep], torch.tensor([1, 2], device="cuda"), *extra, extra_cols])
        cols = torch.cat([cols[keep], torch.tensor([N - 1, 1], device="cuda"), extra_cols,
                          *extra])
    vals = torch.randn(rows.shape[0], device="cuda", generator=gen)

    def csr(r, c):
        order = torch.argsort(r * N + c)
        row_ptr = torch.zeros(N + 1, dtype=torch.int32, device="cuda")
        row_ptr[1:] = torch.cumsum(torch.bincount(r, minlength=N), 0)
        return b8.make_csr(row_ptr, c[order].int(), vals[order])

    return csr(rows, cols), csr(cols, rows)


def _close_to_exact(got, exact, absum, what):
    """|got - exact| <= 1e-6 + 2e-5 * absum + 1e-6 * |exact| per element:
    float32 sums of n terms in any order are off by at most ~n * eps *
    sum|terms| from the exact sum; the kernel's chains are at most 64
    nonzeros plus, for a row of several pieces, a sum over its pieces in a
    block (<= 16) and one over its blocks (<= 20 here); the epilogue rounds
    once more."""
    err = (got.double() - exact).abs()
    bad = err > 1e-6 + 2e-5 * absum + 1e-6 * exact.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} elements out of tolerance, max error "
        f"{float(err.max()):.3g}, rows {torch.nonzero(bad)[:5, 0].tolist()}")


@pytest.mark.parametrize("N,nnz,D,drop,rows", [
    (53_002, 1_000_000, 64, 0.3, "mixed"), (3000, 40_000, 48, 0.0, "mixed"),
    (3000, 40_000, 192, 0.3, "mixed"), (1, 1, 64, 0.3, "mixed"), (500, 4000, 37, 0.3, "mixed"),
    (500, 4000, 64, 0.0, "mixed"), (53_002, 400_000, 64, 0.3, "long"),
    (3000, 40_000, 64, 0.3, "light")])
def test_graph_layer_matches_plain(gen, N, nnz, D, drop, rows):
    """Forward and backward against the plain version run in float64 on the
    same inputs, within ``_close_to_exact``'s bound, and two kernel runs
    bit-equal (no float atomics); a row over 20,000 nonzeros, and a graph
    of light rows only."""
    csr, csr_t = _random_csr(N, nnz, gen, rows)
    x = torch.randn(N, D, device="cuda", generator=gen)
    g = torch.randn(N, D, device="cuda", generator=gen)
    bits = _ints(-2 ** 31, 2 ** 31, (N, D), gen) if drop else None
    keep = 1.0 - drop
    new, side = b8.graph_layer_forward(csr, x, bits, keep)
    gx = b8.graph_layer_backward(csr_t, x, side, bits, keep, g)
    torch.cuda.synchronize()

    def f64(m):
        return m._replace(val=m.val.double())

    e_new, e_side = b8.graph_layer_forward_plain(f64(csr), x.double(), bits, keep)
    absum = b8._spmm_plain(f64(csr)._replace(val=csr.val.double().abs()), x.double().abs())
    _close_to_exact(side, e_side, absum, "side")
    # new = x + side + x * side (/ keep): the error of side, scaled by |1 + x| / keep
    _close_to_exact(new, e_new, absum * (1 + x.double().abs()) / keep + 1e-6, "new")
    gp = b8._dropped_grad(g.double(), bits, keep)
    e_gx = b8.graph_layer_backward_plain(f64(csr_t), x.double(), side.double(), bits, keep,
                                         g.double())
    absum_t = b8._spmm_plain(f64(csr_t)._replace(val=csr_t.val.double().abs()),
                             (gp + gp * x.double()).abs())
    _close_to_exact(gx, e_gx, absum_t + 1e-6, "gx")
    new2, side2 = b8.graph_layer_forward(csr, x, bits, keep)
    assert torch.equal(new, new2) and torch.equal(side, side2)
    assert torch.equal(gx, b8.graph_layer_backward(csr_t, x, side, bits, keep, g))
    if N > 3:  # the empty row: side 0; rows over several blocks on both sides
        assert bool((side[0] == 0).all())
        for m in (csr, csr_t):
            assert (m.split_count.shape[0] >= 1) == (rows != "light")
            assert bool((m.pieces[:, 3] == b8.SINGLE).all()) == (rows == "light")
            assert not bool(m.split_count.any())  # the counts are back at 0


def test_graph_layer_refuses_another_block_size(gen, monkeypatch):
    """Both C entries refuse a schedule laid out for another number of
    pieces a block than the kernel's (its blocks would sum partials that no
    block wrote)."""
    csr, csr_t = _random_csr(500, 4000, gen)
    x = torch.randn(500, 64, device="cuda", generator=gen)
    monkeypatch.setattr(b8, "PIECES_PER_BLOCK", b8.PIECES_PER_BLOCK // 2)
    with pytest.raises(RuntimeError, match="graph_layer_forward"):
        b8.graph_layer_forward(csr, x)
    with pytest.raises(RuntimeError, match="graph_layer_backward"):
        b8.graph_layer_backward(csr_t, x, x, None, 1.0, x)


@pytest.mark.parametrize("B,I,P,integer", [(64, 5001, 25, True), (64, 5001, 25, False),
                                         (7, 70_000, 3, True), (3, 10, 40, True)])
def test_rank_sum_matches_plain(gen, B, I, P, integer):
    """Exactly equal to the plain version, and run to run: the counts are
    integers. Row 0 has no positives, row 1 a positive inside its history
    (holding -inf) and one on PAD; I = 70,000 spans several chunks."""
    if integer:
        scores = torch.randint(-3, 4, (B, I), device="cuda", generator=gen).float()
    else:
        scores = torch.randn(B, I, device="cuda", generator=gen)
    scores[torch.rand(B, I, device="cuda", generator=gen) < 0.01] = -math.inf
    hist = [torch.randint(0, I, (int(c),), device="cuda", generator=gen)
            for c in torch.randint(0, max(I // 8, 2), (B,), generator=torch.Generator().manual_seed(I))]
    hist[1] = torch.cat([hist[1], torch.tensor([5], device="cuda")])
    row_ptr, items = _csr(hist)
    pos = _ints(0, I, (B, P), gen)
    pmask = torch.rand(B, P, device="cuda", generator=gen) < 0.7
    pmask[0] = False
    pos[1, 0], pmask[1, 0], scores[1, 5] = 5, True, -math.inf
    pos[1, -1], pmask[1, -1] = 0, True
    got = b7.rank_sum(scores, row_ptr, items, pos, pmask)
    torch.cuda.synchronize()
    assert torch.equal(got, b7.rank_sum_plain(scores, row_ptr, items, pos, pmask))
    assert torch.equal(got, b7.rank_sum(scores, row_ptr, items, pos, pmask))
    assert float(got[0]) == 0.0


def _rank_sum_case(gen, B, I, P):
    """Integer scores (ties everywhere, so ties straddle every span of a
    cluster), 1% -inf; random histories; P positive slots a row at 70%:
    row 0 without valid positives, row 1 with one inside its history (at
    -inf) and one on PAD, row 2 with a positive at each span's first column
    and the same score on both sides of the boundary."""
    scores = torch.randint(-3, 4, (B, I), device="cuda", generator=gen).float()
    scores[torch.rand(B, I, device="cuda", generator=gen) < 0.01] = -math.inf
    hist = [torch.randint(0, I, (int(c),), device="cuda", generator=gen)
            for c in torch.randint(0, max(I // 8, 2), (B,), generator=torch.Generator().manual_seed(I))]
    pos = _ints(0, I, (B, P), gen)
    pmask = torch.rand(B, P, device="cuda", generator=gen) < 0.7
    pmask[0] = False
    if B > 1 and P > 1:
        j = I // 2
        hist[1] = torch.cat([hist[1], torch.tensor([j], device="cuda")])
        pos[1, 0], pmask[1, 0], scores[1, j] = j, True, -math.inf
        pos[1, -1], pmask[1, -1] = 0, True
    if B > 2:
        span = b7.rank_sum_plan(B, I, P, torch.cuda.get_device_properties(0).multi_processor_count)["span"]
        for k, c in enumerate(range(span, I, span)):
            if k < P:
                pos[2, k], pmask[2, k] = c, True
                scores[2, c - 1] = scores[2, c] = 1.0
    row_ptr, items = _csr(hist)
    return scores, row_ptr, items, pos, pmask


@pytest.mark.parametrize("I", [1, 31, 4980, 5001])
@pytest.mark.parametrize("B", [1, 7, 32, 133, 2048])
def test_rank_sum_plan_shapes_match_plain(gen, B, I):
    """B7 at shapes that reach every branch of its launch plan (a row over
    a cluster of up to 8 blocks, one block a row past the SM count, rows
    narrower than one block's least span) exactly equal to its plain
    version and run to run."""
    args = _rank_sum_case(gen, B, I, 30)
    got = b7.rank_sum(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, b7.rank_sum_plain(*args))
    assert torch.equal(got, b7.rank_sum(*args))
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("integer", [True, False])
def test_rank_sum_many_positives(gen, integer):
    """1,600 positives in 5,001-wide rows: the block's bitonic sort (past
    one warp's 32) and sums up to 2^23, exact."""
    B, I, P = 5, 5001, 1600
    scores, row_ptr, items, _, _ = _rank_sum_case(gen, B, I, 1)
    if not integer:
        scores = torch.randn(B, I, device="cuda", generator=gen)
    pos = torch.stack([torch.randperm(I, device="cuda", generator=gen)[:P] for _ in range(B)]).int()
    pmask = torch.ones(B, P, dtype=torch.bool, device="cuda")
    pmask[0] = False
    got = b7.rank_sum(scores, row_ptr, items, pos, pmask)
    torch.cuda.synchronize()
    assert torch.equal(got, b7.rank_sum_plain(scores, row_ptr, items, pos, pmask))
    assert torch.equal(got, b7.rank_sum(scores, row_ptr, items, pos, pmask))


@pytest.mark.parametrize("C", [32_768, 4097])
def test_rank_sum_candidates_at_the_memory_limit(gen, C):
    """The candidate form's widest rows (32,768 candidates: one block's
    128 KiB sorted list) and a row just past a power of 2, row 1 with 200
    positives (the block's bitonic sort), ties everywhere; wider rows
    raise."""
    B = 3
    scores = torch.randint(-3, 4, (B, C), device="cuda", generator=gen).float()
    cand = torch.rand(B, C, device="cuda", generator=gen) < 0.9
    pos = torch.rand(B, C, device="cuda", generator=gen) < 0.01
    pos[1] = torch.arange(C, device="cuda") < 200  # sums below 2^23: the plain sum is exact
    got = b7.rank_sum_candidates(scores, cand, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, b7.rank_sum_candidates_plain(scores, cand, pos))
    assert torch.equal(got, b7.rank_sum_candidates(scores, cand, pos))
    wide = torch.zeros(B, 32_769, device="cuda")
    with pytest.raises(ValueError):
        b7.rank_sum_candidates(wide, wide > 0, wide > 0)


def _natr_inputs(gen, D, H, N, n_anchor_ids, A):
    """A random history matrix [n_anchor_ids, H] over a source table [N, D]
    with lengths 0 to H (anchor 0 and anchor 1 empty, anchor 2 one slot,
    anchor 3 full), A anchors drawn from it (the four first), and weights."""
    ids = _ints(0, N, (n_anchor_ids, H), gen)
    lens = torch.randint(0, H + 1, (n_anchor_ids,), device="cuda", generator=gen)
    lens[:4] = torch.tensor([0, 0, 1, H])
    mask = torch.arange(H, device="cuda")[None, :] < lens[:, None]
    ids = torch.where(mask, ids, 0)
    hist = b9.History(0.3 * torch.randn(N, D, device="cuda", generator=gen), ids, mask)
    anchors = _ints(0, n_anchor_ids, (A,), gen)
    anchors[:4] = torch.arange(4, dtype=torch.int32)
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device="cuda", generator=gen)
    w = b9.Weights(rnd(D, D, scale=0.2), rnd(D, scale=0.1), rnd(D, 1, scale=0.3),
                   rnd(1, scale=0.1), rnd(D, 1, scale=0.3), rnd(1, scale=0.1))
    return hist, anchors, w


def _natr_close(got, want, rtol, what):
    """|got - want| <= 1e-5 + rtol * max|want|, as chip_smoke.py's B9_TOL."""
    err = float((got - want).abs().max())
    assert err <= 1e-5 + rtol * float(want.abs().max()), f"{what}: error {err}"


def _natr_training(gen, D, H, A, popular):
    """A training call's operands: the history of 3,000 anchor ids over a
    source table of 5,000 rows, the anchor table [3,000, D], A pairs (their
    anchors repeat: ~2,800 distinct at A = 8,192; with ``popular`` one
    anchor takes every eighth pair), queries and an upstream gradient."""
    hist, anchors, w = _natr_inputs(gen, D, H, 5000, 3000, A)
    if popular:
        anchors[4::8] = 5
    table = 0.3 * torch.randn(3000, D, device="cuda", generator=gen)
    q = 0.3 * torch.randn(A, D, device="cuda", generator=gen)
    g = torch.randn(A, device="cuda", generator=gen)
    return hist, table, anchors, q, w, g


@pytest.mark.parametrize("D,H,A,popular", [(64, 50, 8192, False), (64, 50, 8192, True),
                                           (64, 1, 300, False), (32, 70, 1000, False),
                                           (128, 100, 500, False)])
def test_natr_attention_matches_plain(gen, D, H, A, popular):
    """B9's training forward and backward (one anchor stage per distinct
    anchor, from the plan of the anchor ids) against their plain versions:
    the logits, the anchor table's gradient (0 on every row no pair names)
    and the others within ``B9_TOL``; reruns bit-equal, each backward from
    its forward's kept values, as the autograd path runs it; a backward whose
    plan has grouped other ids since is refused."""
    hist, table, anchors, q, w, g = _natr_training(gen, D, H, A, popular)
    plan = row_groups.RowPlan(table.shape[0], "cuda")
    ops.reset_launch_counts()
    got, kept = b9._forward_call(hist, table, anchors, q, w, plan)
    torch.cuda.synchronize()
    assert ops.launch_counts()["group_rows"] == 1
    _natr_close(got, b9.natr_attention_forward_plain(hist, table, anchors, q, w), 1e-4,
                "forward")
    grads = b9.natr_attention_backward(hist, table, anchors, q, w, g, kept)
    torch.cuda.synchronize()
    plain = b9.natr_attention_backward_plain(hist, table, anchors, q, w, g)
    names = ("dtable", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da")
    for name, x, y in zip(names, grads, plain):
        assert x.shape == y.shape, name
        if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
            assert float(x.abs().max()) <= 1e-5
        else:
            _natr_close(x, y, 1e-3, name)
    untouched = torch.ones(table.shape[0], dtype=torch.bool, device="cuda")
    untouched[anchors.long()] = False
    assert not bool(grads[0][untouched].any())
    logits, kept = b9._forward_call(hist, table, anchors, q, w, plan)
    again = b9.natr_attention_backward(hist, table, anchors, q, w, g, kept)
    assert torch.equal(logits, got)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert torch.equal(b9.natr_attention_forward(hist, table, anchors, q, w, plan), got)
    with pytest.raises(ValueError, match="grouped other ids"):
        b9.natr_attention_backward(hist, table, anchors, q, w, g, kept)


@pytest.mark.parametrize("anchor_is_row", [True, False])
def test_natr_full_sort_matches_plain(gen, anchor_is_row):
    """A predict-fallback tile: 32 users x 8,192 items, the anchors on the
    rows (overlap_items) or on the columns (overlap_users)."""
    D, H = 64, 50
    n_anchor = 32 if anchor_is_row else 8192
    hist, _, w = _natr_inputs(gen, D, H, 5000, 9000, 4)
    anchors = _ints(0, 9000, (n_anchor,), gen)
    anchors[:2] = torch.tensor([0, 1], dtype=torch.int32)  # empty histories
    pu = 0.3 * torch.randn(n_anchor, D, device="cuda", generator=gen)
    q = 0.3 * torch.randn(8192 if anchor_is_row else 32, D, device="cuda", generator=gen)
    got = b9.natr_full_sort(hist, anchors, pu, q, w, anchor_is_row)
    torch.cuda.synchronize()
    assert got.shape == (32, 8192)
    _natr_close(got, b9.natr_full_sort_plain(hist, anchors, pu, q, w, anchor_is_row), 1e-4,
                "full-sort")
    assert torch.equal(got, b9.natr_full_sort(hist, anchors, pu, q, w, anchor_is_row))


@pytest.mark.parametrize("anchor_is_row", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_natr_pair_grid_matches_plain(gen, D, anchor_is_row):
    """The anchor table (every anchor row at once) and the pair grid of a
    [33 users x 1,001 items] tile: neither side a multiple of the grid's
    8 x 32 block, the anchors on the rows or on the columns. The table
    within 1e-5 + 1e-4 max of the plain anchor stage, the grid within
    1e-6 + 1e-4 max of the one-call plain full-sort (chip_smoke.py's
    B9_TOL), and both bit-equal from run to run."""
    H, n_users, n_items = 50, 33, 1001
    n_anchor = n_users if anchor_is_row else n_items
    hist, _, w = _natr_inputs(gen, D, H, 5000, 9000, 4)
    table_pu = 0.3 * torch.randn(9000, D, device="cuda", generator=gen)
    every = torch.arange(9000, dtype=torch.int32, device="cuda")
    table = b9.natr_anchor_table(hist, every, table_pu, w)
    torch.cuda.synchronize()
    _natr_close(table, b9.anchor_plain(hist, every, table_pu, w), 1e-4, "anchor table")
    assert torch.equal(table, b9.natr_anchor_table(hist, every, table_pu, w))
    anchors = _ints(0, 9000, (n_anchor,), gen)
    anchors[:2] = torch.tensor([0, 1], dtype=torch.int32)  # empty histories
    pu = table_pu[anchors.long()]
    q = 0.3 * torch.randn(n_items if anchor_is_row else n_users, D, device="cuda", generator=gen)
    got = b9.natr_pair_grid(table[anchors.long()], pu, q, w, anchor_is_row)
    torch.cuda.synchronize()
    assert got.shape == (n_users, n_items)
    want = b9.natr_full_sort_plain(hist, anchors, pu, q, w, anchor_is_row)
    err = float((got - want).abs().max())
    assert err <= 1e-6 + 1e-4 * float(want.abs().max()), f"pair grid: error {err}"
    assert torch.equal(got, b9.natr_pair_grid(table[anchors.long()], pu, q, w, anchor_is_row))


#: B11 tolerance per element, |kernel - plain| <= ATOL + RTOL * the sum of
#: the absolute values of the element's terms (chip_smoke.py's B11_TOL): the
#: kernel and index_add_ add the terms in different orders, with atomics
B11_TOL = (1e-6, 2 ** -18)


def _b11_close(got, want, absum, what):
    diff = (got - want).abs()
    assert bool((diff <= B11_TOL[0] + B11_TOL[1] * absum).all()), \
        f"{what}: error {float(diff.max())}"


def _b11_groups_shared(csr, table, ids, g, plan, groups, want, absum):
    """Two tables on the same ids from one grouping, through autograd: each
    gradient within tolerance of the plain one, the two bit-equal; the ids
    grouped once for the forward of both and the backward of both, and a
    second grouping on the same plan the same as the first."""
    ops.reset_launch_counts()
    t, t2 = table.clone().requires_grad_(), (2 * table).requires_grad_()
    (b11.rating_vector(csr, t, ids, groups) + b11.rating_vector(csr, t2, ids, groups)).backward(g)
    _b11_close(t.grad.float(), want.float(), absum, "autograd")
    assert torch.equal(t.grad, t2.grad)
    assert ops.launch_counts()["group_rows"] == 0
    first = row_groups.canonical(groups)
    row_groups.group_rows(ids, plan)
    assert ops.launch_counts()["group_rows"] == 1  # the one just above
    assert all(torch.equal(a, b) for a, b in zip(first, row_groups.canonical(plan.groups)))


def _b11_history(R, N):
    """Row 0 empty, row 1 of up to 5,000 entries (79 pieces of 64), the rest
    of 0 to 200, on the card."""
    lens = torch.randint(0, 200, (R,), generator=torch.Generator().manual_seed(R))
    lens[0], lens[1] = 0, min(5000, N - 1)
    rows = [torch.randperm(N - 1, generator=torch.Generator().manual_seed(r))[:int(c)] + 1
            for r, c in enumerate(lens)]
    ptr, cols = b11.history_csr(torch.repeat_interleave(torch.arange(R), lens).numpy(),
                                torch.cat(rows).numpy(), R)
    return b11.history_tensors(ptr, cols, N, "cuda")


@pytest.mark.parametrize("R,N,D,B,same", [(3000, 27_800, 64, 16_384, False),
                                          (500, 1000, 48, 777, False),
                                          (40, 300, 130, 100, False),
                                          (3000, 27_800, 64, 4096, True)])
def test_rating_vector_matches_plain(gen, R, N, D, B, same):
    """Row 0 empty, row 1 of 5,000 entries (79 pieces of 64), the rest of 0
    to 200; ids repeat (the first 64 all row 1, others drawn from 50 rows);
    an id whose row is empty among them, or (``same``) every id row 1.
    Forward and backward within ``B11_TOL`` and bit-equal over two runs;
    one grouping (``group_rows``) serves two tables and both directions."""
    csr = _b11_history(R, N)
    ids = _ints(0, min(R, 50), (B,), gen)
    ids[:64], ids[64] = 1, 0
    if same:
        ids[:] = 1
    plan = row_groups.RowPlan(R, "cuda")
    groups = row_groups.group_rows(ids, plan)
    table = torch.randn(N, D, device="cuda", generator=gen)
    g = torch.randn(B, D, device="cuda", generator=gen)
    got = b11.rating_vector_forward(csr, table, ids, groups)
    torch.cuda.synchronize()
    _b11_close(got, b11.rating_vector_plain(csr, table, ids),
               b11.rating_vector_plain(csr, table.abs(), ids), "forward")
    assert torch.equal(got[0], got[63]) and (same or bool((got[64] == 0).all()))
    assert torch.equal(got, b11.rating_vector_forward(csr, table, ids, groups))
    dt = b11.rating_vector_backward(csr, N, ids, g, torch.float32, groups)
    torch.cuda.synchronize()
    want = b11.rating_vector_backward_plain(csr, N, ids, g)
    absum = b11.rating_vector_backward_plain(csr, N, ids, g.abs())
    _b11_close(dt, want, absum, "backward")
    assert torch.equal(dt, b11.rating_vector_backward(csr, N, ids, g, torch.float32, groups))
    _b11_groups_shared(csr, table, ids, g, plan, groups, want, absum)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rating_vector_reads_past_stale_row_heads(gen, dtype):
    """Two steps' ids through one ``RowPlan`` in turn: the first names rows
    0-2,999 (so every entry of the plan's row map is set), the second 50
    rows of them, a shifted set, and ids outside the rows (-1, R, R + 7).
    The second step's forward and backward, read past the first step's
    stale row map, equal bit for bit those from a fresh plan's grouping, and
    the out-of-range ids' output rows are zeros."""
    R, N, D = 3000, 27_800, 64
    csr = _b11_history(R, N)
    table = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    plan = row_groups.RowPlan(R, "cuda")
    first = torch.randperm(R, device="cuda", generator=gen).to(torch.int32).repeat(3)
    row_groups.group_rows(first, plan)
    g1 = torch.randn(first.shape[0], D, device="cuda", generator=gen)
    b11.rating_vector_forward(csr, table, first, plan.groups)
    b11.rating_vector_backward(csr, N, first, g1, dtype, plan.groups)
    ids = _ints(1000, 1050, (8192,), gen)
    ids[:70] = 1
    ids[70], ids[71], ids[72] = -1, R, R + 7
    g = torch.randn(ids.shape[0], D, device="cuda", generator=gen)
    stale = row_groups.group_rows(ids, plan)
    got = (b11.rating_vector_forward(csr, table, ids, stale),
           b11.rating_vector_backward(csr, N, ids, g, dtype, stale))
    fresh = row_groups.group_rows(ids, row_groups.RowPlan(R, "cuda"))
    want = (b11.rating_vector_forward(csr, table, ids, fresh),
            b11.rating_vector_backward(csr, N, ids, g, dtype, fresh))
    torch.cuda.synchronize()
    assert int(stale.meta[0]) == ids.shape[0] - 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool((got[0][70:73] == 0).all())
    own = ids[(ids >= 0) & (ids < R)]
    _b11_close(got[0][(ids >= 0) & (ids < R)], b11.rating_vector_plain(csr, table, own),
               b11.rating_vector_plain(csr, table.abs(), own), "forward after a stale map")


@pytest.mark.parametrize("B,C,k", [(25, 2525, 10), (40, 7, 7), (3, 1, 1), (64, 300, 64),
                                   (1, 2525, 10), (32, 2525, 10), (33, 2525, 64),
                                   (2048, 2525, 10)])
def test_candidate_topk_and_rank_sum_match_plain(gen, B, C, k):
    """Integer scores (ties everywhere); row 0 fully padded, row 1 with
    fewer candidates than 10, the rest padded at random lengths; positives
    first in each row, so column 0 is one. B10 and the candidate rank sums
    exactly equal to their plain versions, and run to run."""
    scores = torch.randint(-3, 4, (B, C), device="cuda", generator=gen).float()
    lens = torch.randint(1, C + 1, (B,), device="cuda", generator=gen)
    lens[0] = 0
    if B > 1:
        lens[1] = min(C, 5)
    cand = torch.arange(C, device="cuda")[None, :] < lens[:, None]
    n_pos = torch.minimum(torch.randint(1, 26, (B,), device="cuda", generator=gen), lens)
    pos = torch.arange(C, device="cuda")[None, :] < n_pos[:, None]
    got = b10.candidate_topk(scores, cand, k)
    torch.cuda.synchronize()
    assert torch.equal(got, b10.candidate_topk_plain(scores, cand, k))
    assert torch.equal(got, b10.candidate_topk(scores, cand, k))  # run to run
    rs = b7.rank_sum_candidates(scores, cand, pos)
    torch.cuda.synchronize()
    assert torch.equal(rs, b7.rank_sum_candidates_plain(scores, cand, pos))
    assert torch.equal(rs, b7.rank_sum_candidates(scores, cand, pos))
    assert float(rs[0]) == 0.0
    normal = torch.randn(B, C, device="cuda", generator=gen)
    assert torch.equal(b10.candidate_topk(normal, cand, k), b10.candidate_topk_plain(normal, cand, k))
    assert torch.equal(b7.rank_sum_candidates(normal, cand, pos),
                       b7.rank_sum_candidates_plain(normal, cand, pos))


def test_streaming_and_dense_metrics_agree(gen):
    """CMF on the bundled pair with real-valued (normal) factors: the
    streaming path (B5 in 3xTF32) and the dense path (float32 matmul, K4)
    give the same metrics; the top-k ids agree wherever the dense scores of
    neighbouring ranks differ by more than B5's tolerance."""
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
    from recbole_cdr_tpu_torch.models.cmf import CMF
    from recbole_cdr_tpu_torch.utils import init_seed

    config = CDRConfig(model="CMF", config_dict={"state": "ERROR", "device": "cuda"},
                       _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    _, _, test_data = data_preparation(config, dataset)
    model = CMF(config, dataset).cuda()
    with torch.no_grad():
        model.user_embedding.normal_(generator=gen)
        model.item_embedding.normal_(generator=gen)
    ev = FullSortEvaluator(config)
    factors = model.full_sort_factors("TARGET")
    dense = ev.evaluate(lambda users: model.full_sort(users), test_data, "cuda")
    stream = ev.evaluate_streaming(factors, test_data, "cuda")
    print(f"dense {dense}\nstreaming {stream}")
    ids_d = ev.topk_ids(lambda users: model.full_sort(users), test_data, "cuda")
    ids_s = ev.streaming_topk_ids(factors, test_data, "cuda")
    uids = torch.as_tensor(test_data.uid_list, device="cuda")
    with torch.no_grad():
        top = torch.gather(model.full_sort(uids), 1, torch.as_tensor(ids_d, device="cuda"))
    gap = torch.diff(top, dim=1).abs() > 1e-4 + 1e-5 * top[:, 1:].abs()
    clear = torch.ones_like(gap[:, :1])
    clear = (torch.cat([clear, gap], 1) & torch.cat([gap, clear], 1)).cpu().numpy()
    assert (ids_d[clear] == ids_s[clear]).all()
    assert dense == stream


def _run_on_the_card(tmp_path, monkeypatch, model="CMF", **extra):
    from recbole_cdr_tpu_torch import run_recbole_cdr

    monkeypatch.chdir(tmp_path)
    ops.reset_launch_counts()
    result = run_recbole_cdr(model=model, config_dict={
        "state": "ERROR", "device": "cuda", "train_epochs": ["BOTH:2"],
        "train_batch_size": 1024, **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    return ops.launch_counts()


def test_run_recbole_cdr_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch)
    slice1 = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
              "masked_topk")
    assert all(counts[k] > 0 for k in slice1), counts
    assert counts["streaming_topk"] == counts["sparse_adam"] == 0, counts


def test_catalog_path_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, phase_optimizer="sparse",
                              streaming_topk_threshold=1)
    path = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
            "streaming_topk", "sparse_adam")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["masked_topk"] == 0, counts


def test_bitgcf_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, model="BiTGCF")
    path = ("gather_dot_forward", "gather_dot_backward", "neg_sampler", "swap_or_not",
            "masked_topk", "graph_layer_forward", "graph_layer_backward")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["streaming_topk"] == counts["sparse_adam"] == 0, counts


def test_natr_on_the_card(gen, tmp_path, monkeypatch):
    counts = _run_on_the_card(tmp_path, monkeypatch, model="NATR",
                              train_epochs=["SOURCE:1", "TARGET:1"],
                              metrics=["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"])
    path = ("gather_dot_forward", "gather_dot_backward", "group_rows", "neg_sampler",
            "swap_or_not", "masked_topk", "rank_sum", "natr_attention_forward",
            "natr_attention_backward", "natr_anchor_table", "natr_pair_grid")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts
    # a plan per K1 backward and per B9 forward (the step's anchor ids)
    assert counts["group_rows"] == (counts["gather_dot_backward"]
                                    + counts["natr_attention_forward"]), counts


@pytest.mark.parametrize("mode", ["full", "uniform 20", "labeled"])
def test_dtcdr_on_the_card(gen, tmp_path, monkeypatch, mode):
    """DTCDR (DMF) in each eval mode: B11 forward and backward and its plan
    in training, the mode's kernels in evaluation (K4 for full-sort, B10 and the
    candidate B7 for candidates, none for labeled), B5, B6, B8 and B9
    never."""
    eval_args = {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "RO",
                 "mode": mode}
    extra = {"base_model": "DMF", "eval_args": eval_args}
    if mode == "labeled":
        extra.update(threshold={"rating": 4}, source_val_interval=None, target_val_interval=None,
                     metrics=["AUC", "MAE", "RMSE", "LogLoss"], valid_metric="AUC")
    else:
        extra["metrics"] = ["Recall", "MRR", "NDCG", "Hit", "Precision", "GAUC"]
    counts = _run_on_the_card(tmp_path, monkeypatch, model="DTCDR", **extra)
    path = {"full": ("masked_topk", "rank_sum"),
            "uniform 20": ("candidate_topk", "rank_sum_candidates"), "labeled": ()}[mode]
    path += ("neg_sampler", "swap_or_not", "rating_vector_forward", "rating_vector_backward",
             "group_rows")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts
    # one grouping of both sides' ids a step and an evaluation pass, for its
    # four B11 forwards
    assert counts["rating_vector_forward"] == 4 * counts["group_rows"], counts


@pytest.mark.parametrize("M,n_ov,D,k", [(9000, 2001, 64, 10), (300, 20, 37, 1),
                                        (1000, 500, 130, 17), (70, 33, 8, 32),
                                        (5, 2001, 64, 16),
                                        # the screen's tiles cut: M off the 64-row
                                        # blocks, n_ov under one 64-row tile and off
                                        # the MMA's 8, D 32 / 64 / 100, k 1-32
                                        (1000, 45, 32, 16), (777, 2001, 100, 10),
                                        (130, 61, 64, 17), (4097, 300, 32, 32),
                                        (200, 3000, 100, 1), (65, 59, 64, 10)])
def test_benchmark_topk_matches_plain(gen, M, n_ov, D, k):
    """B12 against its plain version: ids exact where the k-th and (k+1)-th
    similarity differ by more than 1e-5 (the all-zero rows: exactly 0..k-1),
    the rows within 1e-5 + 1e-5·|x| there, NaN where ``sn + t_pop`` is 0;
    two runs bit-equal."""
    rest = torch.randn((M, D), generator=gen, device="cuda") * 0.3
    src = torch.randn((n_ov, D), generator=gen, device="cuda") * 0.3
    rest[::3] = 0.0
    s_pop = _ints(0, 5, (n_ov,), gen).float()
    t_pop = _ints(0, 5, (M,), gen).float()
    out, idx, sim = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    out2, idx2, sim2 = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    assert torch.equal(idx, idx2) and torch.equal(sim, sim2)
    assert torch.equal(out.nan_to_num(7.0), out2.nan_to_num(7.0))
    p_out, p_idx, p_sim = b12.benchmark_topk_plain(rest, src, s_pop, t_pop, k)
    zero = (rest == 0).all(1)
    assert (idx[zero] == torch.arange(k, device="cuda")).all()
    srt = torch.sort((rest.double() @ src.double().T), 1, descending=True).values
    clear = (srt[:, k - 1] - srt[:, k] > 1e-5 if n_ov > k
             else torch.ones(M, dtype=torch.bool, device="cuda")) | zero
    assert clear.float().mean() > 0.5
    assert torch.equal(idx[clear].sort(1).values, p_idx[clear].sort(1).values)
    torch.testing.assert_close(sim, p_sim, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[clear], p_out[clear], atol=1e-5, rtol=1e-5, equal_nan=True)
    assert torch.isnan(out).any() == torch.isnan(p_out).any()


@pytest.mark.parametrize("copies", [3, 50])
def test_benchmark_topk_near_ties(gen, copies):
    """Source rows in groups of ``copies`` near-copies of 10 rows (each within
    1e-7 of its group's row, the group's first copy exact), so a row's best
    candidates differ by far less than the screen's error: with 3 copies the
    lists hold them, with 50 they outgrow their room and the rows are
    rescored whole. Per row: k distinct ids ordered by similarity (value
    descending, the lower id first on a tie), each within 1e-5 of its float64
    similarity, none below the (k+1)-th float64 similarity by more than
    1e-5; the similarities within B12's tolerance of the plain version's;
    two runs bit-equal."""
    M, D, k = 300, 64, 10
    n_ov = 10 * copies
    base = torch.randn((10, D), generator=gen, device="cuda") * 0.3
    noise = torch.randn((n_ov, D), generator=gen, device="cuda") * 1e-7
    noise[::10] = 0.0
    src = base.repeat(copies, 1) + noise
    rest = torch.randn((M, D), generator=gen, device="cuda") * 0.3
    s_pop = _ints(0, 5, (n_ov,), gen).float()
    t_pop = _ints(1, 5, (M,), gen).float()
    out, idx, sim = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    out2, idx2, sim2 = b12.benchmark_topk(rest, src, s_pop, t_pop, k)
    assert torch.equal(idx, idx2) and torch.equal(sim, sim2) and torch.equal(out, out2)
    exact = rest.double() @ src.double().T
    assert bool((idx.sort(1).values.diff(1) > 0).all())  # distinct
    picked = exact.gather(1, idx.long())
    assert bool(((picked - sim.double()).abs() <= 1e-5).all())
    assert bool((sim[:, :-1] >= sim[:, 1:]).all())
    tie = sim[:, :-1] == sim[:, 1:]
    assert bool((idx[:, :-1][tie] < idx[:, 1:][tie]).all())
    kth = torch.topk(exact, k + 1, 1).values[:, k]
    assert bool((picked.min(1).values >= kth - 1e-5).all())
    p_sim = b12.benchmark_topk_plain(rest, src, s_pop, t_pop, k)[2]
    torch.testing.assert_close(sim, p_sim, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model,extra", [
    ("DCDCSR", {"train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"]}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"], "loss_type": "BPR",
               "latent_factor_model": "BPR"}),
    ("SSCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"]}),
], ids=["DCDCSR", "EMCDR-CE", "EMCDR-BPR", "SSCDR"])
def test_mapping_models_on_the_card(gen, tmp_path, monkeypatch, model, extra):
    """The three mapping models' schedules: K2 and K3 in the device-path
    phases, K4 in evaluation, K1 for the dot-product models, B12 once per
    DCDCSR run; B5 to B11 never."""
    counts = _run_on_the_card(tmp_path, monkeypatch, model=model, **extra)
    path = ("neg_sampler", "swap_or_not", "masked_topk")
    if model != "SSCDR":  # K1's backward groups the step's ids by row
        path += ("gather_dot_forward", "gather_dot_backward", "group_rows")
    assert all(counts[k] > 0 for k in path), counts
    assert counts["benchmark_topk"] == (model == "DCDCSR"), counts
    assert all(counts[k] == 0 for k in counts if k not in path + ("benchmark_topk",)), counts


# ---- B13 (bf16 streaming top-k), B2a (popularity negatives), K1-bf16

#: B13 against its plain version, |kernel - plain| <= ATOL + RTOL * the sum of
#: the absolute values of a score's D products: the products are exact in
#: float32 on both sides, the float32 sums run in other orders (the tensor
#: cores may cut rather than round each add), D <= 64 adds of at most
#: 2^-23 each bound the difference by 2^-17 of that sum; RTOL doubles it
B13_TOL = (1e-6, 2 ** -16)


def _bf16_case(gen, B, I, D, integer, dtype=torch.bfloat16):
    if integer:
        U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).to(dtype)
        T = torch.randint(-3, 4, (I, D), device="cuda", generator=gen).to(dtype)
    else:
        U = torch.randn(B, D, device="cuda", generator=gen).to(dtype)
        T = torch.randn(I, D, device="cuda", generator=gen).to(dtype)
    hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
            for c in torch.randint(0, 50, (B,), generator=torch.Generator().manual_seed(B))]
    hist[0] = torch.randperm(I - 1, device="cuda", generator=gen)[:I - 1 - 10] + 1
    return U, T, *_csr(hist)


def _b13_tol(U, T, ids):
    absum = (U.float().abs()[:, None, :] * T.float().abs()[ids.long()]).sum(-1)
    return B13_TOL[0] + B13_TOL[1] * absum


@pytest.mark.parametrize("B,I,D,k,dtype", [(40, 1_100_001, 64, 10, torch.bfloat16),
                                           (70, 40_001, 64, 64, torch.bfloat16),
                                           (33, 20_000, 16, 1, torch.bfloat16),
                                           (9, 3000, 24, 32, torch.bfloat16),
                                           (5, 90, 136, 10, torch.bfloat16),
                                           (70, 40_001, 64, 10, torch.float16),
                                           (9, 3000, 24, 32, torch.float16)])
def test_streaming_topk_bf16_matches_plain(gen, B, I, D, k, dtype):
    """B13 on bf16 factors (and its float16 instance): integer-valued ones
    score exactly (ids and scores equal the plain version's, row 0 masked
    down to 10 items); normal ones within ``B13_TOL``, ids equal wherever
    neighbouring scores differ by more. D of 24 and 136 take the
    element-wise staging path."""
    for integer in (True, False):
        U, T, row_ptr, items = _bf16_case(gen, B, I, D, integer, dtype)
        ops.reset_launch_counts()
        got_s, got_i = b5.streaming_topk(U, T, row_ptr, items, k)
        torch.cuda.synchronize()
        assert ops.launch_counts()["streaming_topk_bf16"] == 1
        assert ops.launch_counts()["streaming_topk"] == 0
        want_s, want_i = b5.streaming_topk_bf16(U.cpu(), T.cpu(), row_ptr.cpu(), items.cpu(), k)
        want_s, want_i = want_s.cuda(), want_i.cuda()
        if integer:
            assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
            continue
        tol = _b13_tol(U, T, want_i)
        assert bool(((got_s - want_s).abs() <= tol).all())
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        clear = torch.ones_like(want_i, dtype=torch.bool)
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        assert torch.equal(got_i[clear], want_i[clear])


def test_streaming_topk_bf16_against_b5(gen):
    """B13 and B5 on the same values (B5 on the exact float32 upcast): the
    same function, one bf16 product against three TF32 products a score."""
    U, T, row_ptr, items = _bf16_case(gen, 64, 300_001, 64, integer=False)
    a_s, a_i = b5.streaming_topk(U, T, row_ptr, items, 10)
    b_s, b_i = b5.streaming_topk(U.float(), T.float(), row_ptr, items, 10)
    tol = _b13_tol(U, T, b_i) + 1e-4 + 1e-5 * b_s.abs()  # plus B5's own tolerance
    assert bool(((a_s - b_s).abs() <= tol).all())
    gap = torch.diff(b_s, dim=1).abs() > tol[:, 1:]
    clear = torch.ones_like(b_i, dtype=torch.bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert torch.equal(a_i[clear], b_i[clear])


@pytest.mark.parametrize("B,I,D,k,dtype", [
    # D: one box (TMA, zero-filled to the k16 depth), several boxes a stage,
    # and widths TMA cannot address (element-wise staging: 20, 100)
    (63, 40_001, 8, 10, torch.bfloat16), (64, 90, 16, 1, torch.bfloat16),
    (65, 40_001, 24, 64, torch.bfloat16), (129, 90, 64, 10, torch.bfloat16),
    (1, 40_001, 136, 10, torch.bfloat16), (63, 3000, 256, 64, torch.bfloat16),
    (65, 3000, 20, 10, torch.bfloat16), (33, 90, 100, 64, torch.float16),
    (129, 64, 64, 64, torch.bfloat16), (1, 10, 64, 10, torch.float16),
    (2048, 1_100_001, 64, 10, torch.bfloat16), (40, 1_100_001, 64, 1, torch.float16),
    (2048, 40_001, 256, 10, torch.float16), (65, 40_001, 136, 64, torch.float16)])
def test_streaming_topk_bf16_hopper_edges(gen, B, I, D, k, dtype):
    """B13's wgmma / TMA tile kernel at the edges of its launch plan: every
    staging form, two and four consumer warpgroups and partial row blocks, an item axis of exactly k, shorter than one 64-item tile,
    and the catalog's 1,100,001. Row 0 masked down to fewer than k items
    (masked ties decide its tail). Integer-valued factors: ids and scores
    equal the plain version's (run on the card); normal ones within
    ``B13_TOL``, ids equal wherever neighbours differ by more. One launch a
    call."""
    for integer in (True, False):
        U, T, _, _ = _bf16_case(gen, B, I, D, integer, dtype)
        hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
                for c in torch.randint(0, min(50, I), (B,), generator=torch.Generator().manual_seed(D))]
        hist[0] = torch.randperm(I - 1, device="cuda", generator=gen)[:I - k] + 1  # k - 1 left
        row_ptr, items = _csr(hist)
        ops.reset_launch_counts()
        got_s, got_i = b5.streaming_topk_bf16(U, T, row_ptr, items, k)
        torch.cuda.synchronize()
        assert ops.launch_counts()["streaming_topk_bf16"] == 1
        want_s, want_i = b5.streaming_topk_bf16_plain(U, T, row_ptr, items, k)
        assert bool((got_s[0, k - 1:] == torch.finfo(torch.float32).min).all())  # masked tail
        if integer:
            assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
            continue
        tol = _b13_tol(U, T, want_i)
        assert bool(((got_s - want_s).abs() <= tol).all())
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        clear = torch.ones_like(want_i, dtype=torch.bool)
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        assert torch.equal(got_i[clear], want_i[clear])


@pytest.mark.parametrize("n_alias,H,neg_num,rows", [
    (300_000, 400, 1, "full"), (40, 37, 2, "full"), (1, 8, 1, "full"),
    (300_000, 2048, 1, "padded"), (40, 64, 2, "junk")])
def test_neg_sampler_popularity_matches_plain(gen, n_alias, H, neg_num, rows):
    """B2a bit-exact: the alias draw and the rejection, a one-column table
    included; rows with live lengths as ``test_neg_sampler_matches_plain``'s."""
    n_users = 4000
    values = torch.randperm(2 * n_alias, device="cuda", generator=gen)[:n_alias].to(torch.int32) + 1
    prob = torch.rand(n_alias, device="cuda", generator=gen) * 1.2
    alias = _ints(-1, n_alias, (n_alias,), gen)
    hist, lens = _history_rows(n_users, H, 2 * n_alias + 1, gen, rows)
    uids = _ints(0, n_users, (30_000,), gen)
    uids[:64] = 0
    base = _ints(-2 ** 31, 2 ** 31, (30_000 * neg_num,), gen)
    accept = _ints(-2 ** 31, 2 ** 31, (30_000 * neg_num,), gen)
    got = k2.sample_negatives_popularity(base, accept, uids, hist, (values, prob, alias), neg_num,
                                         lens)
    torch.cuda.synchronize()
    want = k2.sample_negatives_plain(base, uids, hist, None, neg_num, (values, prob, alias),
                                     accept, lens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["grouped", "positions", "broken"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 48, 100])
def test_gather_dot_bf16_matches_plain(gen, D, dtype, form):
    """K1's 16-bit form: scores within one ulp of the type of the plain
    version's (both sum in float32 and round once; plus 2^-18 of the sum of
    the products' magnitudes, the float32 sums' order); gradients in every
    form ``torch.equal`` to the plain version on CPU copies (float32 sums in
    position order, rounded once) and to a second run."""
    U, I, u, i, g, positions = _k1_case(form, D, dtype, gen)
    got, want = k1.gather_dot_forward(U, I, u, i), k1.gather_dot_plain(U, I, u, i)
    assert got.dtype == dtype
    # one ulp, plus the float32 sums' order where they cancel to near 0
    absum = k1.gather_dot_plain(U.float().abs(), I.float().abs(), u, i)
    ulp = torch.finfo(dtype).eps * want.float().abs() + 2 ** -18 * absum
    assert bool(((got.float() - want.float()).abs() <= ulp).all())
    rescans = k1.positions_rescans("cuda")
    runs = [k1.gather_dot_backward(U, I, u, i, g, k1.backward_groups(U, I, u, i, positions))
            for _ in range(2)]
    assert k1.positions_rescans("cuda") == rescans + 2 * (form == "broken")
    ref = k1.gather_dot_backward_plain(*(t.cpu() for t in (U, I, u, i, g)))
    for got, again, want in zip(*runs, ref):
        assert got.dtype == dtype
        assert torch.equal(got, again) and torch.equal(got.cpu(), want)


def test_bf16_catalog_path_on_the_card(gen, tmp_path, monkeypatch):
    """compute_dtype and eval_score_dtype bfloat16 with the sparse optimizer
    and streaming evaluation: K1's bf16 form, B6 and B13, never B5."""
    counts = _run_on_the_card(tmp_path, monkeypatch, phase_optimizer="sparse",
                              streaming_topk_threshold=1, compute_dtype="bfloat16",
                              eval_score_dtype="bfloat16")
    path = ("gather_dot_forward_bf16", "gather_dot_backward_bf16", "neg_sampler",
            "swap_or_not", "streaming_topk_bf16", "sparse_adam", "group_rows")
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts
    # K1 reads the step's sub-tables by position: the plans are B6's alone
    assert counts["group_rows"] == counts["sparse_adam"], counts


@pytest.mark.parametrize("model,extra", [
    ("CMF", {"learner": "adagrad", "phase_optimizer": "per_phase"}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"], "loss_type": "BPR",
               "latent_factor_model": "BPR", "learner": "rmsprop"}),
], ids=["CMF-adagrad", "EMCDR-BPR-rmsprop"])
def test_popularity_negatives_on_the_card(gen, tmp_path, monkeypatch, model, extra):
    """Popularity training negatives through B2a on the pointwise and the
    pairwise stream; the uniform sampler never launches."""
    counts = _run_on_the_card(tmp_path, monkeypatch, model=model,
                              neg_sampling={"popularity": 1}, **extra)
    assert counts["neg_sampler_popularity"] > 0 and counts["neg_sampler"] == 0, counts


def _b14(U, shards, row_ptr, items, k, L, I):
    """B14 in one process: every shard's local stage at its offset, then the
    merge kernel over the lists in shard order."""
    lists = [b5.sharded_topk_local(U, s, row_ptr, items, k, j * L, I) for j, s in enumerate(shards)]
    return b5.sharded_topk_merge(torch.stack([s for s, _ in lists]),
                                 torch.stack([i for _, i in lists]), k)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("B,I,D,k", [(40, 1_100_001, 64, 10), (33, 20_003, 64, 64),
                                     (70, 9001, 17, 16), (5, 70, 8, 20)])
def test_sharded_topk_matches_plain_and_b5(gen, m, B, I, D, k):
    """B14's local stage and merge: the table split into m shards of ceil(I /
    m) rows, the last padded with random rows that must never win (at I = 70,
    m = 4 the last shard holds 16 rows, fewer than k, its list padded).
    Integer-valued factors: ids and scores equal the plain version's and one
    B5 call over the whole table; row 0's history spans every shard, row 1
    masks all but 3 items (masked ties decide). Normal factors: within
    1e-4 + 1e-5 |s| of the plain version, ids equal wherever neighbours
    differ by more. Each wrapper launches once per call."""
    L = -(-I // m)
    hist = [torch.randperm(I, device="cuda", generator=gen)[:int(c)]
            for c in torch.randint(0, 50, (B,), generator=torch.Generator().manual_seed(B))]
    hist[0] = torch.randperm(I, device="cuda", generator=gen)[:min(I - 1, 20_000)]
    hist[1] = torch.randperm(I, device="cuda", generator=gen)[:I - 3]
    row_ptr, items = _csr(hist)
    for integer in (True, False):
        if integer:
            U = torch.randint(-3, 4, (B, D), device="cuda", generator=gen).float()
            T = torch.randint(-3, 4, (L * m, D), device="cuda", generator=gen).float()
        else:
            U = torch.randn(B, D, device="cuda", generator=gen)
            T = torch.randn(L * m, D, device="cuda", generator=gen)
        T[I:] = 100.0  # pad rows: they would win every row if they competed
        shards = T.split(L)
        ops.reset_launch_counts()
        got_s, got_i = _b14(U, shards, row_ptr, items, k, L, I)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["sharded_topk_local"] == sum(j * L < I for j in range(m))
        assert counts["sharded_topk_merge"] == 1 and counts["streaming_topk"] == 0
        lists = [b5.sharded_topk_local_plain(U, s, row_ptr, items, k, j * L, I)
                 for j, s in enumerate(shards)]
        want_s, want_i = b5.sharded_topk_merge_plain(torch.stack([s for s, _ in lists]),
                                                     torch.stack([i for _, i in lists]), k)
        if integer:
            assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
            one_s, one_i = b5.streaming_topk(U, T[:I], row_ptr, items, k)
            assert torch.equal(got_i, one_i) and torch.equal(got_s, one_s)
            continue
        tol = 1e-4 + 1e-5 * want_s.abs()
        assert bool(((got_s - want_s).abs() <= tol).all())
        gap = torch.diff(want_s, dim=1).abs() > tol[:, 1:]
        clear = torch.ones_like(want_i, dtype=torch.bool)
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        assert torch.equal(got_i[clear], want_i[clear])


def test_sharded_topk_bf16_against_b13(gen):
    """B14 on bf16 factors goes through B13's tile kernel at each shard's
    offset: on integer-valued factors ids and scores equal one B13 call over
    the whole table; on normal ones within ``B13_TOL`` of the plain version."""
    I, m, k = 300_001, 4, 10
    L = -(-I // m)
    for integer in (True, False):
        U, T, row_ptr, items = _bf16_case(gen, 64, L * m, 64, integer)
        T[I:] = 100.0
        row_ptr, items = _csr([torch.randperm(I, device="cuda", generator=gen)[:30]
                               for _ in range(64)])
        got_s, got_i = _b14(U, T.split(L), row_ptr, items, k, L, I)
        if integer:
            one_s, one_i = b5.streaming_topk(U, T[:I], row_ptr, items, k)
            assert torch.equal(got_i, one_i) and torch.equal(got_s, one_s)
            continue
        want_s, want_i = b5.sharded_streaming_topk_plain(U, T[:I], row_ptr, items, k, m)
        tol = _b13_tol(U, T, want_i)
        assert bool(((got_s - want_s).abs() <= tol).all())


@pytest.mark.parametrize("m", [1, 2, 4])
def test_sharded_topk_bf16_bit_equal_b13(gen, m):
    """B14's 16-bit local stage is B13's tile kernel at each shard's offset:
    on integer-valued factors ids and scores equal one B13 call over the
    whole table at m = 1, 2 and 4 shards (the last padded with rows that
    would win if they competed)."""
    I, k = 300_001, 10
    L = -(-I // m)
    U, T, _, _ = _bf16_case(gen, 64, L * m, 64, True)
    T[I:] = 100.0
    row_ptr, items = _csr([torch.randperm(I, device="cuda", generator=gen)[:30]
                           for _ in range(64)])
    got_s, got_i = _b14(U, T.split(L), row_ptr, items, k, L, I)
    one_s, one_i = b5.streaming_topk(U, T[:I], row_ptr, items, k)
    assert torch.equal(got_i, one_i) and torch.equal(got_s, one_s)


@pytest.mark.parametrize("distributed", [False, True])
def test_mesh_on_the_card(gen, tmp_path, monkeypatch, distributed):
    """CMF over a one-rank NCCL mesh (``mesh_shape`` alone: an in-process
    store; with ``distributed``: a TCP one), streaming forced: B14's local
    stage and merge launch, B5 never; the metrics equal the run without the
    mesh; the process group is gone afterwards."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = {"mesh_shape": {"data": 1, "model": 1}, "streaming_topk_threshold": 1}
    if distributed:
        extra["distributed"] = {"coordinator_address": f"127.0.0.1:{port}",
                                "num_processes": 1, "process_id": 0}
    from recbole_cdr_tpu_torch import run_recbole_cdr

    monkeypatch.chdir(tmp_path)
    cfg = {"state": "ERROR", "device": "cuda", "train_epochs": ["BOTH:2"],
           "train_batch_size": 1024, "streaming_topk_threshold": 1}
    ops.reset_launch_counts()
    mesh = run_recbole_cdr(model="CMF", config_dict={**cfg, **extra})
    counts = ops.launch_counts()
    assert not torch.distributed.is_initialized()
    assert counts["sharded_topk_local"] == counts["sharded_topk_merge"] > 0, counts
    assert counts["streaming_topk"] == counts["masked_topk"] == 0, counts
    single = run_recbole_cdr(model="CMF", config_dict=cfg)
    assert mesh["test_result"] == single["test_result"]


@pytest.mark.parametrize("model,extra", [
    ("CMF", {"phase_optimizer": "sparse", "compute_dtype": "bfloat16",
             "eval_score_dtype": "bfloat16"}),
    ("EMCDR", {"train_epochs": ["SOURCE:1", "TARGET:1", "OVERLAP:1"],
               "phase_optimizer": "sparse"}),
    ("DCDCSR", {"train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]}),
])
def test_mesh_options_on_the_card(gen, tmp_path, monkeypatch, model, extra):
    """The sparse optimizer (B6's row-shard form at offset 0), bf16 compute
    (B14's 16-bit local stage) and the mapping models over a one-rank NCCL
    mesh, streaming forced: the test metrics within 0.02 of the run without
    the mesh; B6 launches wherever the sparse optimizer trains."""
    from recbole_cdr_tpu_torch import run_recbole_cdr

    monkeypatch.chdir(tmp_path)
    cfg = {"state": "ERROR", "device": "cuda", "train_epochs": ["BOTH:2"],
           "train_batch_size": 1024, "streaming_topk_threshold": 1, **extra}
    ops.reset_launch_counts()
    mesh = run_recbole_cdr(model=model, config_dict={**cfg,
                                                     "mesh_shape": {"data": 1, "model": 1}})
    counts = ops.launch_counts()
    assert not torch.distributed.is_initialized()
    assert counts["sharded_topk_local"] == counts["sharded_topk_merge"] > 0, counts
    assert (counts["sparse_adam"] > 0) == (cfg.get("phase_optimizer") == "sparse"), counts
    single = run_recbole_cdr(model=model, config_dict=cfg)
    for k, v in single["test_result"].items():
        assert abs(mesh["test_result"][k] - v) < 0.02, (k, mesh["test_result"][k], v)


# ---- B16 (DeepAPF's attention-gated score) and B15 (CoNet's tower)

#: B16 against its plain version per output tensor, |kernel - plain| <= ATOL
#: + RTOL * max|plain| (B9's form): the kernel sums x @ W's products, the
#: attention logit and the predict dot in other orders than cuBLAS and
#: torch; the weight gradients add per block, then block by block
B16_TOL = {"forward": (1e-5, 1e-4), "grid": (1e-6, 1e-4), "backward": (1e-5, 1e-3)}

#: B15 per probability, |kernel - plain| <= ATOL + RTOL * the logit's
#: absolute chain (see ``chip_smoke.py::B15_TOL``)
B15_TOL = (1e-6, 2 ** -16)


def _b16_close(got, want, what):
    atol, rtol = B16_TOL[what]
    assert float((got - want).abs().max()) <= atol + rtol * float(want.abs().max()), what


def _b16_weights(gen, D):
    from recbole_cdr_tpu_torch.ops.deepapf_attention import Weights

    r = lambda *s, scale: scale * torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    return Weights(r(D, D, scale=D ** -0.5), r(D, scale=0.1), r(D, 1, scale=0.3),
                   r(D, 1, scale=0.3))


def _b16_call(gen, D, P, dtype=torch.float32, scale=0.3, overlapped=3600):
    """B16's operands for P pairs, the first (P + 1) // 2 the source
    domain's, on five tables (6,000 entity rows, 5,000 other-side rows),
    random ids with the overlapped count and the one above it first (40% of
    the entities masked), and the logits' gradient: ((tables, pairs,
    overlapped, weights), gradient, entity ids)."""
    N, M = 6000, 5000
    tabs = b16.Tables(*((scale * torch.randn(n, D, device="cuda", generator=gen)).to(dtype)
                        for n in (N, N, N, M, M)))
    ent, oth = _ints(0, N, (P,), gen), _ints(0, M, (P,), gen)
    if overlapped >= 0:
        ent[:2] = torch.tensor([overlapped, overlapped + 1], device="cuda")[:min(2, P)]
    n_src = (P + 1) // 2
    pairs = b16.Pairs(ent[:n_src], oth[:n_src], ent[n_src:], oth[n_src:])
    w = b16.Weights(*(t.to(dtype) for t in _b16_weights(gen, D)))
    g = torch.randn(P, device="cuda", generator=gen).to(dtype)
    return (tabs, pairs, overlapped, w), g, ent


def _share_rows(ent, overlapped):
    """(the masked entities, the unmasked ones) of the call's ids."""
    return (torch.unique(ent[ent > overlapped].long()),
            torch.unique(ent[ent <= overlapped].long()))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("P", [16_384, 37, 1])
def test_deepapf_attention_matches_plain(gen, D, P):
    """B16's forward and backward from the five tables and both domains'
    ids against their plain versions, every tile size's tail, the masked
    entities' share rows exactly without gradient, two runs bit-equal."""
    args, g, ent = _b16_call(gen, D, P)
    a = b16.deepapf_forward(*args)
    _b16_close(a, b16.deepapf_forward_plain(*args), "forward")
    assert torch.equal(a, b16.deepapf_forward(*args))
    ka = b16.deepapf_backward(*args, g)
    for x, y in zip(ka, b16.deepapf_backward_plain(*args, g)):
        assert x.shape == y.shape
        _b16_close(x, y, "backward")
    masked, named = _share_rows(ent, args[2])
    assert not ka[0][masked].any() and ka[0][named].any()
    assert all(torch.equal(x, y) for x, y in zip(ka, b16.deepapf_backward(*args, g)))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("entity_is_item", [True, False])
@pytest.mark.parametrize("B,I", [(32, 4980), (1, 7), (33, 129)])
def test_deepapf_grid_matches_plain(gen, D, entity_is_item, B, I):
    """B16's grid form from the tables and ids, the overlapped count's
    boundary among the entities, against its plain version; bit-equal
    reruns."""
    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16

    n = 6000
    tabs = [0.3 * torch.randn(n, D, device="cuda", generator=gen) for _ in range(3)]
    users = _ints(0, n, (B,), gen)
    items = _ints(0, n, (I,), gen)
    ov = 2000
    (items if entity_is_item else users)[:2] = torch.tensor([ov, ov + 1], device="cuda")[:min(
        2, I if entity_is_item else B)]
    w = _b16_weights(gen, D)
    args = (*tabs, users, items, ov, entity_is_item, w)
    got = b16.deepapf_grid(*args)
    assert got.shape == (B, I)
    _b16_close(got, b16.deepapf_grid_plain(*args), "grid")
    assert torch.equal(got, b16.deepapf_grid(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("entity_is_item", [True, False])
@pytest.mark.parametrize("B,I", [(1, 1), (7, 4979), (33, 1), (33, 4979)])
def test_deepapf_grid_tiles_match_plain(gen, B, I, D, entity_is_item, dtype):
    """The grid's 2-D tiles (8 users x 16 items) with B and I ragged against
    them, every entity overlapped, none, and the boundary, against the plain
    version (float32 within ``B16_TOL``, float16 within ``_prob16_close``);
    bit-equal reruns."""
    n = 6000
    tabs = [(0.3 * torch.randn(n, D, device="cuda", generator=gen)).to(dtype) for _ in range(3)]
    users, items = _ints(0, n, (B,), gen), _ints(0, n, (I,), gen)
    w = b16.Weights(*(t.to(dtype) for t in _b16_weights(gen, D)))
    ents = items if entity_is_item else users
    for ov in (n, -1, int(ents[0])):  # none masked, all masked, the boundary
        args = (*tabs, users, items, ov, entity_is_item, w)
        got = b16.deepapf_grid(*args)
        torch.cuda.synchronize()
        want = b16.deepapf_grid_plain(*args)
        assert got.shape == (B, I) and got.dtype == dtype
        if dtype == torch.float32:
            _b16_close(got, want, "grid")
        else:
            _prob16_close(got, want)
        assert torch.equal(got, b16.deepapf_grid(*args))


def test_deepapf_rejects_other_widths(gen):
    with pytest.raises(ValueError, match="widths"):
        b16.deepapf_forward(*_b16_call(gen, 48, 8)[0])


def _b15_case(gen, H0, later, B, I):
    r = lambda *s, scale=0.5: scale * torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    dims = [H0] + later
    layers = [(r(a, b, scale=(2 / (a + b)) ** 0.5), r(b, scale=0.1))
              for a, b in zip(dims, dims[1:])]
    out = (r(dims[-1], 1, scale=(2 / (dims[-1] + 1)) ** 0.5), r(1, scale=0.1))
    return r(B, H0), r(I, H0), r(H0, scale=0.1), layers, out


@pytest.mark.parametrize("H0,later,B,I", [
    (64, [32, 16, 8], 2048, 4980),   # the published tower at a dense tile
    (64, [32, 16, 8], 1, 7),
    (32, [16], 33, 4980),
    (6, [5, 3], 33, 129),            # widths padded to 16, the last to 8
    (40, [24, 10], 1, 4981),         # one user; 4,981 items: a ragged last item tile
    (16, [], 5, 300),                # one layer: the output straight after it
    (128, [128] * 5, 9, 1000),       # the largest tower: its fragments read from memory
])
def test_conet_tower_matches_plain(gen, H0, later, B, I):
    """B15 against its plain version per probability within ``B15_TOL`` of
    the logit's absolute chain; bit-equal reruns; a saturating call (every
    logit above 17) exactly 1.0 as the plain version."""
    from recbole_cdr_tpu_torch.ops import conet_tower as b15

    hu, hi, b0, layers, out = _b15_case(gen, H0, later, B, I)
    got = b15.conet_tower(hu, hi, b0, layers, out)
    want = b15.conet_tower_plain(hu, hi, b0, layers, out)
    a = hu.abs()[:, None, :] + hi.abs()[None, :, :] + b0.abs()
    for W, b in layers:
        a = a @ W.abs() + b.abs()
    scale = (a @ out[0].abs() + out[1].abs())[..., 0]
    assert got.shape == (B, I)
    assert bool(((got - want).abs() <= B15_TOL[0] + B15_TOL[1] * scale).all())
    assert torch.equal(got, b15.conet_tower(hu, hi, b0, layers, out))
    sat = (out[0], out[1] + 40.0)
    assert bool((b15.conet_tower(hu, hi, b0, layers, sat) == 1.0).all())
    assert bool((b15.conet_tower_plain(hu, hi, b0, layers, sat) == 1.0).all())


def test_conet_tower_rejects_wide_towers(gen):
    from recbole_cdr_tpu_torch.ops import conet_tower as b15

    hu, hi, b0, layers, out = _b15_case(gen, 64, [132], 4, 10)
    with pytest.raises(ValueError, match="at most"):
        b15.conet_tower(hu, hi, b0, layers, out)


@pytest.mark.parametrize("model", ["CLFM", "DeepAPF", "CoNet"])
def test_both_phase_models_on_the_card(gen, tmp_path, monkeypatch, model):
    """CLFM (dense full-sort), DeepAPF (B16 in training, the plan of each
    backward's keys, and the predict fallback's grid) and CoNet (B15 in the
    dense full-sort): K2, K3 and K4 and the model's kernels, no other."""
    counts = _run_on_the_card(tmp_path, monkeypatch, model=model)
    path = ("neg_sampler", "swap_or_not", "masked_topk")
    path += {"CLFM": (), "DeepAPF": ("deepapf_forward", "deepapf_backward", "group_rows",
                                     "deepapf_grid"),
             "CoNet": ("conet_tower",)}[model]
    assert all(counts[k] > 0 for k in path), counts
    assert all(counts[k] == 0 for k in counts if k not in path), counts
    assert counts.get("deepapf_forward", 0) == counts.get("deepapf_backward", 0)
    assert counts.get("group_rows", 0) == counts.get("deepapf_backward", 0)


# ---- the 16-bit forms of B8, B9 and B11 (compute_dtype: bfloat16) ----------

#: one 16-bit step of a value v is at most 2^-7 |v| in bf16 (2^-10 |v| in
#: float16); the kernels and the plain versions sum in float32 in other
#: orders, so a rounded value may land one step apart, and a value computed
#: from a rounded one carries that step on
STEP = 2 ** -7
#: of the 16-bit probabilities of B15-bf16 and B16-bf16's grid, the share
#: that may differ from the plain version's at all (``_prob16_close``)
PROB16_SHARE = 0.01


def _prob16_close(got, want, controls=()):
    """16-bit probabilities against their plain version's: each within EPS
    (2 |p| + 4 p (1 - p) |z|) + EPS TINY, EPS and TINY the type's and z the
    logit of p (two to four steps of p, four steps of the logit through the
    sigmoid's slope: both sides round the same named values from float32
    sums in other orders, so a value lands a step apart only near a rounding
    point), and at most ``PROB16_SHARE`` of them (one at least) apart at
    all. Each of ``controls``, probabilities a wrong kernel would give, must
    fail that rule."""
    fi = torch.finfo(want.dtype)
    p = want.float()
    z = torch.nan_to_num(torch.log(p) - torch.log1p(-p), nan=0.0, posinf=0.0, neginf=0.0)
    tol = fi.eps * (2 * p + 4 * p * (1 - p) * z.abs()) + fi.eps * fi.tiny
    allowed = max(1, int(PROB16_SHARE * p.numel()))

    def passes(x):
        diff = (x.to(want.dtype).float() - p).abs()
        return bool((diff <= tol).all()) and int((diff > 0).sum()) <= allowed

    assert got.dtype == want.dtype and passes(got)
    for x in controls:
        assert not passes(x)


def _to(csr, dtype):
    return csr._replace(val=csr.val.to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("N,nnz,D,drop,rows", [
    (53_002, 1_000_000, 64, 0.3, "mixed"), (3000, 40_000, 32, 0.0, "mixed"),
    (3000, 40_000, 128, 0.3, "mixed"), (500, 4000, 64, 0.0, "mixed"),
    (500, 4000, 37, 0.3, "mixed"), (53_002, 400_000, 64, 0.3, "long"),
    (3000, 40_000, 64, 0.0, "light")])
def test_graph_layer_bf16_matches_plain(gen, N, nnz, D, drop, rows, dtype):
    """B8's 16-bit form against its plain version on the same 16-bit inputs
    (light rows and rows of several pieces, D 32 / 64 / 128 and one without
    vector loads, dropout on and off): side within one step of the plain
    version's plus 2^-16 of its terms' magnitudes (float32 sums in another
    order), new within two steps of the magnitudes it adds, gx within one
    step of its own plus 2^-16 of its product's terms; two runs bit-equal
    (no atomics); the wrappers count the 16-bit launches only."""
    csr, csr_t = (_to(m, dtype) for m in _random_csr(N, nnz, gen, rows))
    x = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    g = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    bits = _ints(-2 ** 31, 2 ** 31, (N, D), gen) if drop else None
    keep = 1.0 - drop
    ops.reset_launch_counts()
    new, side = b8.graph_layer_forward(csr, x, bits, keep)
    gx = b8.graph_layer_backward(csr_t, x, side, bits, keep, g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["graph_layer_forward_bf16"] == counts["graph_layer_backward_bf16"] == 1
    assert counts["graph_layer_forward"] == counts["graph_layer_backward"] == 0
    assert new.dtype == side.dtype == gx.dtype == dtype
    p_new, p_side = (t.float() for t in b8.graph_layer_forward_plain(csr, x, bits, keep))
    absum = b8._spmm_plain(csr._replace(val=csr.val.abs()), x.abs()).float()
    xa = x.float().abs()
    assert bool(((side.float() - p_side).abs() <= STEP * p_side.abs() + 2 ** -16 * absum).all())
    scale = (p_new.abs() + (p_side.abs() + 2 ** -16 * absum) * (1 + xa)) / keep
    assert bool(((new.float() - p_new).abs() <= 2 * STEP * scale + 1e-6).all()), "new"
    p_gx = b8.graph_layer_backward_plain(csr_t, x, side, bits, keep, g).float()
    gp = b8._dropped_grad(g.float(), bits, keep)
    absum_t = b8._spmm_plain(csr_t._replace(val=csr_t.val.abs()),
                             (gp + gp * x.float()).abs()).float()
    assert bool(((gx.float() - p_gx).abs() <= STEP * p_gx.abs() + 2 ** -16 * absum_t
                 + 1e-6).all()), "gx"
    new2, side2 = b8.graph_layer_forward(csr, x, bits, keep)
    assert torch.equal(new, new2) and torch.equal(side, side2)
    assert torch.equal(gx, b8.graph_layer_backward(csr_t, x, side, bits, keep, g))


def test_graph_layer_bf16_refuses_mixed_types(gen):
    """A 16-bit table with float32 CSR values (or the other way round) is
    refused: the kernel reads both in one type."""
    csr, _ = _random_csr(500, 4000, gen)
    x = torch.randn(500, 64, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        b8.graph_layer_forward(csr, x.bfloat16())
    with pytest.raises(TypeError):
        b8.graph_layer_forward(_to(csr, torch.bfloat16), x)


def _natr16(hist, anchors, w, dtype, *dense):
    return (b9.History(hist.src.to(dtype), hist.ids, hist.mask), anchors,
            b9.Weights(*(t.to(dtype) for t in w)), *(t.to(dtype) for t in dense))


def _natr16_close(got, want, what):
    """Within 1e-5 (the float32 form's absolute term: ``db_ua`` is 0 in exact
    arithmetic, a sum of rounding noise over every pair and slot) plus four
    16-bit steps of the tensor's largest value: each side rounds h, the
    scores, the softmax, su, the gates, beta, zu and the logit from float32
    sums taken in other orders (cuBLAS for the plain version's transfer), so
    a rounded intermediate may land a step apart."""
    assert got.dtype == want.dtype, what
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-5 + 4 * STEP * float(want.float().abs().max()), f"{what}: error {err}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D,H,A", [(64, 50, 8192), (32, 70, 1000), (128, 100, 500), (64, 1, 300)])
def test_natr_attention_bf16_matches_plain(gen, D, H, A, dtype):
    """B9's 16-bit training forward and backward against their plain
    versions on the same 16-bit inputs (empty, one-slot and full
    histories), within ``_natr16_close``; two runs bit-equal; the 16-bit
    wrappers count, the float32 ones do not."""
    hist, table, anchors, q, w, g = _natr_training(gen, D, H, A, A == 8192)
    hist, anchors, w, table, q, g = _natr16(hist, anchors, w, dtype, table, q, g)
    plan = row_groups.RowPlan(table.shape[0], "cuda")
    ops.reset_launch_counts()
    got, kept = b9._forward_call(hist, table, anchors, q, w, plan)
    grads = b9.natr_attention_backward(hist, table, anchors, q, w, g, kept)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["natr_attention_forward_bf16"] == counts["natr_attention_backward_bf16"] == 1
    assert counts["natr_attention_forward"] == counts["natr_attention_backward"] == 0
    _natr16_close(got, b9.natr_attention_forward_plain(hist, table, anchors, q, w), "forward")
    plain = b9.natr_attention_backward_plain(hist, table, anchors, q, w, g)
    names = ("dtable", "dq", "dW", "db", "dw_ua", "db_ua", "dw_da", "db_da")
    for name, x, y in zip(names, grads, plain):
        assert x.shape == y.shape and x.dtype == dtype, name
        if name == "db_da":  # 0 in exact arithmetic: beta depends on b_s - b_p
            assert float(x.float().abs().max()) <= 1e-5
        else:
            _natr16_close(x, y, name)
    logits, kept = b9._forward_call(hist, table, anchors, q, w, plan)
    again = b9.natr_attention_backward(hist, table, anchors, q, w, g, kept)
    assert torch.equal(logits, got)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("anchor_is_row", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_natr_pair_grid_bf16_matches_plain(gen, D, anchor_is_row, dtype):
    """B9's 16-bit anchor table (every anchor row at once) and pair grid of
    a [33 users x 1,001 items] tile, both overlap modes, against the plain
    versions within ``_natr16_close``, 16-bit outputs, bit-equal reruns."""
    H, n_users, n_items = 50, 33, 1001
    n_anchor = n_users if anchor_is_row else n_items
    hist, _, w = _natr_inputs(gen, D, H, 5000, 9000, 4)
    table_pu = 0.3 * torch.randn(9000, D, device="cuda", generator=gen)
    q = 0.3 * torch.randn(n_items if anchor_is_row else n_users, D, device="cuda", generator=gen)
    every = torch.arange(9000, dtype=torch.int32, device="cuda")
    hist, every, w, table_pu, q = _natr16(hist, every, w, dtype, table_pu, q)
    ops.reset_launch_counts()
    table = b9.natr_anchor_table(hist, every, table_pu, w)
    torch.cuda.synchronize()
    assert table.dtype == dtype
    _natr16_close(table, b9.anchor_plain(hist, every, table_pu, w), "anchor table")
    assert torch.equal(table, b9.natr_anchor_table(hist, every, table_pu, w))
    anchors = _ints(0, 9000, (n_anchor,), gen)
    anchors[:2] = torch.tensor([0, 1], dtype=torch.int32)  # empty histories
    pu, su = table_pu[anchors.long()], table[anchors.long()]
    got = b9.natr_pair_grid(su, pu, q, w, anchor_is_row)
    torch.cuda.synchronize()
    assert got.shape == (n_users, n_items) and got.dtype == dtype
    _natr16_close(got, b9.pair_grid_plain(su, pu, q, w, anchor_is_row), "pair grid")
    assert torch.equal(got, b9.natr_pair_grid(su, pu, q, w, anchor_is_row))
    counts = ops.launch_counts()
    assert counts["natr_anchor_table_bf16"] == 2 and counts["natr_pair_grid_bf16"] == 2
    assert counts["natr_anchor_table"] == counts["natr_pair_grid"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("R,N,D,B,same", [(3000, 27_800, 64, 16_384, False),
                                          (500, 1000, 32, 777, False),
                                          (40, 300, 128, 100, False),
                                          (40, 300, 130, 100, False),
                                          (3000, 27_800, 64, 4096, True)])
def test_rating_vector_bf16_matches_plain(gen, R, N, D, B, same, dtype):
    """B11's 16-bit form: 16-bit rows summed in float32 (float32 out, within
    B11_TOL of the plain version), the backward's float32 sums rounded once
    to the table's type (within one step of the plain version's plus
    2^-17 of the terms' magnitudes), twice, bit-equal, and through autograd
    (one grouping for two tables and both directions); ``same``: every id row
    1, of 5,000 entries."""
    csr = _b11_history(R, N)
    ids = _ints(0, min(R, 50), (B,), gen)
    ids[:64], ids[64] = 1, 0
    if same:
        ids[:] = 1
    groups = row_groups.group_rows(ids, row_groups.RowPlan(R, "cuda"))
    table = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    g = torch.randn(B, D, device="cuda", generator=gen)
    ops.reset_launch_counts()
    got = b11.rating_vector_forward(csr, table, ids, groups)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _b11_close(got, b11.rating_vector_plain(csr, table, ids),
               b11.rating_vector_plain(csr, table.abs(), ids), "forward")
    assert torch.equal(got[0], got[63]) and (same or bool((got[64] == 0).all()))
    assert torch.equal(got, b11.rating_vector_forward(csr, table, ids, groups))
    want = b11.rating_vector_backward_plain(csr, N, ids, g, dtype)
    absum = b11.rating_vector_backward_plain(csr, N, ids, g.abs())
    runs = []
    for what in ("backward", "backward, second run"):
        dt = b11.rating_vector_backward(csr, N, ids, g, dtype, groups)
        torch.cuda.synchronize()
        assert dt.dtype == dtype
        diff = (dt.float() - want.float()).abs()
        assert bool((diff <= 1e-6 + 2 ** -17 * absum + STEP * want.float().abs()).all()), what
        runs.append(dt)
    assert torch.equal(*runs)
    t = table.clone().requires_grad_()
    b11.rating_vector(csr, t, ids, groups).backward(g)
    assert t.grad.dtype == dtype
    counts = ops.launch_counts()
    assert counts["rating_vector_forward_bf16"] == 3 and counts["rating_vector_backward_bf16"] == 3
    assert counts["rating_vector_forward"] == counts["rating_vector_backward"] == 0
    ops.reset_launch_counts()
    t, t2 = table.clone().requires_grad_(), (2 * table).requires_grad_()
    (b11.rating_vector(csr, t, ids, groups) + b11.rating_vector(csr, t2, ids, groups)).backward(g)
    assert ops.launch_counts()["group_rows"] == 0
    assert torch.equal(t.grad, t2.grad) and t.grad.dtype == dtype


# ---- the 16-bit forms of B16 and B15 ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("P", [16_384, 37])
def test_deepapf_attention_bf16_matches_plain(gen, D, P, dtype):
    """B16's 16-bit forward and backward against their plain versions on the
    same 16-bit operands within ``_natr16_close`` (both round x, z, the a's,
    alpha, entity_e and the logit from float32 sums in other orders), every
    output 16-bit, the masked entities' share rows exactly without gradient,
    two runs bit-equal; the 16-bit wrappers count, the float32 ones do
    not."""
    args, g, ent = _b16_call(gen, D, P, dtype)
    ops.reset_launch_counts()
    a = b16.deepapf_forward(*args)
    ka = b16.deepapf_backward(*args, g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["deepapf_forward_bf16"] == counts["deepapf_backward_bf16"] == 1
    assert counts["deepapf_forward"] == counts["deepapf_backward"] == 0
    assert a.dtype == dtype and all(x.dtype == dtype for x in ka)
    _natr16_close(a, b16.deepapf_forward_plain(*args), "forward")
    assert torch.equal(a, b16.deepapf_forward(*args))
    names = ("d_share", "d_only_src", "d_only_tgt", "d_other_src", "d_other_tgt", "dW", "db",
             "dw2", "dpl")
    for name, x, y in zip(names, ka, b16.deepapf_backward_plain(*args, g)):
        assert x.shape == y.shape, name
        _natr16_close(x, y, name)
    masked, named = _share_rows(ent, args[2])
    assert not ka[0][masked].any() and ka[0][named].any()
    assert all(torch.equal(x, y) for x, y in zip(ka, b16.deepapf_backward(*args, g)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("entity_is_item", [True, False])
def test_deepapf_grid_bf16_matches_plain(gen, D, entity_is_item, dtype):
    """B16's 16-bit grid on a [33 x 1,001] tile from 16-bit tables whose
    probabilities spread, the overlapped count's boundary among the
    entities, against its plain version within ``_prob16_close``, which a
    constant 0.5 fails; 16-bit probabilities; bit-equal reruns."""
    n, B, I, ov = 6000, 33, 1001, 2000
    tabs = [(0.6 * torch.randn(n, D, device="cuda", generator=gen)).to(dtype) for _ in range(3)]
    users, items = _ints(0, n, (B,), gen), _ints(0, n, (I,), gen)
    (items if entity_is_item else users)[:2] = torch.tensor([ov, ov + 1], device="cuda")
    w = b16.Weights(*(t.to(dtype) for t in _b16_weights(gen, D)))
    args = (*tabs, users, items, ov, entity_is_item, w)
    ops.reset_launch_counts()
    got = b16.deepapf_grid(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["deepapf_grid_bf16"] == 1
    assert ops.launch_counts()["deepapf_grid"] == 0
    assert got.shape == (B, I) and got.dtype == dtype
    want = b16.deepapf_grid_plain(*args)
    _prob16_close(got, want, (torch.full_like(want, 0.5),))
    assert torch.equal(got, b16.deepapf_grid(*args))


def test_deepapf_float16_masked_logit_has_no_nan(gen):
    """Under float16 JAX's -1e31 share logit is -inf; the kernels keep their
    float32 mask, so with every pair masked alpha_s is exactly 0: the
    logits, the probabilities and every gradient are finite and equal to
    the plain versions' within ``_natr16_close``, the share rows' gradients
    exactly 0. Large attention logits (wide rows) included."""
    P, D, dtype = 4096, 64, torch.float16
    # the overlapped count -2: every entity id above it, every pair masked
    args, g, _ = _b16_call(gen, D, P, dtype, scale=1.2, overlapped=-2)
    a = b16.deepapf_forward(*args)
    ka = b16.deepapf_backward(*args, g)
    assert bool(torch.isfinite(a).all()) and all(bool(torch.isfinite(x).all()) for x in ka)
    _natr16_close(a, b16.deepapf_forward_plain(*args), "forward")
    assert not ka[0].any()
    for x, y in zip(ka, b16.deepapf_backward_plain(*args, g)):
        _natr16_close(x, y, "backward")
    tabs, w = args[0], args[3]
    ids = torch.arange(64, dtype=torch.int32, device="cuda")
    grid_args = (tabs.share, tabs.only_tgt, tabs.other_tgt, ids, ids, -1, True, w)
    grid = b16.deepapf_grid(*grid_args)  # every entity above -1: masked
    assert bool(torch.isfinite(grid).all())
    _natr16_close(grid, b16.deepapf_grid_plain(*grid_args), "grid")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("H0,later,B,I", [
    (64, [32, 16, 8], 2048, 4980),   # the published tower at a dense tile
    (64, [32, 16, 8], 1, 7),
    (6, [5, 3], 33, 129),            # widths padded to 16, the last to 8
    (40, [24, 10], 1, 4981),         # one user; 4,981 items: a ragged last item tile
    (128, [128] * 5, 9, 1000),       # the largest tower: 164 KB of fragments staged
])
def test_conet_tower_bf16_matches_plain(gen, H0, later, B, I, dtype):
    """B15's 16-bit form against its plain version on the same 16-bit
    operands within ``_prob16_close``; at the dense tile a constant 0.5 and
    the float32 kernel on the same values, rounded only at its output, fail
    that check; 16-bit output; bit-equal reruns; a saturating call exactly
    1.0; the 16-bit wrapper counts, the float32 one does not."""
    hu, hi, b0, layers, out = _b15_case(gen, H0, later, B, I)
    hu, hi, b0 = hu.to(dtype), hi.to(dtype), b0.to(dtype)
    layers = [(W.to(dtype), b.to(dtype)) for W, b in layers]
    out = tuple(t.to(dtype) for t in out)
    ops.reset_launch_counts()
    got = b15.conet_tower(hu, hi, b0, layers, out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conet_tower_bf16"] == 1 and ops.launch_counts()["conet_tower"] == 0
    assert got.shape == (B, I) and got.dtype == dtype
    want = b15.conet_tower_plain(hu, hi, b0, layers, out)
    controls = ()
    if B * I > 10 ** 6:
        wide = b15.conet_tower(hu.float(), hi.float(), b0.float(),
                               [(W.float(), b.float()) for W, b in layers],
                               tuple(t.float() for t in out))
        controls = (torch.full_like(want, 0.5), wide)
    _prob16_close(got, want, controls)
    assert torch.equal(got, b15.conet_tower(hu, hi, b0, layers, out))
    sat = (out[0], (out[1].float() + 40.0).to(dtype))
    assert bool((b15.conet_tower(hu, hi, b0, layers, sat) == 1.0).all())


@pytest.mark.parametrize("model,extra,path", [
    ("BiTGCF", {}, ("graph_layer_forward_bf16", "graph_layer_backward_bf16",
                    "gather_dot_forward_bf16", "gather_dot_backward_bf16", "masked_topk")),
    ("NATR", {"train_epochs": ["SOURCE:1", "TARGET:1"]},
     ("gather_dot_forward_bf16", "gather_dot_backward_bf16", "natr_attention_forward_bf16",
      "natr_attention_backward_bf16", "natr_anchor_table_bf16", "natr_pair_grid_bf16",
      "masked_topk")),
    ("DTCDR", {"base_model": "DMF"}, ("rating_vector_forward_bf16",
                                      "rating_vector_backward_bf16", "group_rows",
                                      "masked_topk")),
    ("CoNet", {}, ("neg_sampler", "swap_or_not", "masked_topk", "conet_tower_bf16")),
    ("DeepAPF", {}, ("neg_sampler", "swap_or_not", "masked_topk", "deepapf_forward_bf16",
                     "deepapf_backward_bf16", "group_rows", "deepapf_grid_bf16")),
])
def test_bf16_models_on_the_card(gen, tmp_path, monkeypatch, model, extra, path):
    """BiTGCF, NATR (SOURCE then TARGET), DTCDR's DMF, CoNet and DeepAPF
    under compute_dtype bfloat16 through the entry point: the 16-bit forms
    launch, the float32 B8, B9, B11, B15 and B16 never."""
    counts = _run_on_the_card(tmp_path, monkeypatch, model=model, compute_dtype="bfloat16",
                              **extra)
    assert all(counts[k] > 0 for k in path), counts
    float32 = ("graph_layer_forward", "graph_layer_backward", "natr_attention_forward",
               "natr_attention_backward", "natr_anchor_table", "natr_pair_grid",
               "rating_vector_forward", "rating_vector_backward", "conet_tower",
               "deepapf_forward", "deepapf_backward", "deepapf_grid")
    assert all(counts[k] == 0 for k in float32), counts
