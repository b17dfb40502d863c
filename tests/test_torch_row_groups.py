"""The grouping of a step's ids by row (``ops/row_groups.py``), on the CPU
where its wrappers run their plain versions: the plan against a numpy
reference, exactly (empty ids, all distinct, one id at every other
position, ids outside a shard and the mesh's padding, one popular row, which
is listed as a head of more than ``BIG_TERMS`` positions), and
the row sum that reads it against numpy's sequential adds in float32,
rounded once (what ``index_add_`` gives on the CPU, 16-bit rows included).
One kept :class:`RowPlan` serves steps of different lengths, the shorter
last step included. The card's plan and row sum are held to these plain
versions in ``tests/test_torch_cuda.py``."""

import copy

import numpy as np
import pytest
import torch

from recbole_cdr_tpu_torch.ops import launch_counts
from recbole_cdr_tpu_torch.ops.row_groups import (
    BIG_TERMS,
    RowPlan,
    canonical,
    group_rows,
    row_sum,
)
from recbole_cdr_tpu_torch.parallel.mesh import OCCURRENCE_PAD


def _case(kind, rng):
    """(ids, rows, offset) of one case."""
    if kind == "empty":
        return np.zeros(0, np.int32), 40, 0
    if kind == "distinct":
        return rng.permutation(60)[:45].astype(np.int32), 60, 0
    if kind == "every_other":
        ids = rng.integers(0, 50, 301).astype(np.int32)
        ids[::2] = 9
        return ids, 50, 0
    if kind == "outside":  # a shard [30, 55) of 100 rows, with the mesh's padding
        ids = rng.integers(0, 100, 200).astype(np.int32)
        ids[::9] = OCCURRENCE_PAD
        return ids, 25, 30
    ids = rng.integers(0, 80, 500).astype(np.int32)  # popular: one row at 300 positions
    ids[rng.permutation(500)[:300]] = 3
    return ids, 80, 0


def _reference(ids, rows, offset):
    """Per distinct row in [offset, offset + rows), ascending: (local row,
    its positions in ascending order)."""
    local = ids.astype(np.int64) - offset
    own = sorted(set(local[(local >= 0) & (local < rows)].tolist()))
    return [(r, np.flatnonzero(local == r)) for r in own]


@pytest.mark.parametrize("kind", ["empty", "distinct", "every_other", "outside", "popular"])
def test_group_rows_plain_matches_numpy(kind):
    ids, rows, offset = _case(kind, np.random.default_rng(7))
    before = launch_counts()["group_rows"]
    g = group_rows(torch.from_numpy(ids), RowPlan(rows, "cpu", offset))
    assert launch_counts()["group_rows"] == before  # the plain version: no launch
    ref = _reference(ids, rows, offset)
    n_own = sum(len(p) for _, p in ref)
    n_big = sum(len(p) > BIG_TERMS for _, p in ref)
    assert g.meta.tolist()[:3] == [n_own, len(ref), n_big]
    np.testing.assert_array_equal(g.big[:n_big].numpy(),
                                  [h for h, (_, p) in enumerate(ref) if len(p) > BIG_TERMS])
    assert g.R == len(ids) and g.L == rows and g.offset == offset
    H = len(ref)
    np.testing.assert_array_equal(g.head_row[:H].numpy(), [r for r, _ in ref])
    np.testing.assert_array_equal(g.head_len[:H].numpy(), [len(p) for _, p in ref])
    np.testing.assert_array_equal(g.head_start[:H].numpy(),
                                  np.cumsum([0] + [len(p) for _, p in ref])[:H])
    np.testing.assert_array_equal(g.pos[:n_own].numpy(),
                                  np.concatenate([p for _, p in ref] or [np.zeros(0)]))
    want_map = np.full(rows, -1)
    want_map[[r for r, _ in ref]] = np.arange(H)
    np.testing.assert_array_equal(g.row_head.numpy(), want_map)
    rows_c, lens_c, pos_c = canonical(g)
    np.testing.assert_array_equal(rows_c.numpy(), [r for r, _ in ref])
    np.testing.assert_array_equal(pos_c.numpy(), g.pos[:n_own].numpy())


def test_group_rows_groups_two_sets_at_once():
    """``second``: both groupings, each its plain version."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 30, 90).astype(np.int32)
    b = rng.integers(0, 12, 40).astype(np.int32)
    ga, gb = group_rows(torch.from_numpy(a), RowPlan(30, "cpu"),
                        second=(torch.from_numpy(b), RowPlan(12, "cpu")))
    for g, ids, rows in ((ga, a, 30), (gb, b, 12)):
        ref = _reference(ids, rows, 0)
        assert [r for r, _ in ref] == canonical(g)[0].tolist()
        np.testing.assert_array_equal(canonical(g)[2].numpy(),
                                      np.concatenate([p for _, p in ref]))


def test_row_plan_kept_across_steps():
    """One plan of a shard's rows, kept from step to step as a table's
    state keeps it: steps of 500, 64, 0 and 301 ids (the shorter last step
    after a longer one) each group as the numpy reference, and every plan
    counts in ``generation``."""
    rng = np.random.default_rng(5)
    plan = RowPlan(25, "cpu", 30)
    for k, R in enumerate((500, 64, 0, 301)):
        ids = rng.integers(0, 100, R).astype(np.int32)
        ids[::3] = 41  # one popular row of the shard
        g = group_rows(torch.from_numpy(ids), plan)
        ref = _reference(ids, 25, 30)
        assert g.R == R and plan.generation == k + 1
        assert canonical(g)[0].tolist() == [r for r, _ in ref]
        np.testing.assert_array_equal(canonical(g)[2].numpy(),
                                      np.concatenate([p for _, p in ref] or [np.zeros(0)]))
    twin = copy.deepcopy(plan)  # a copied model's plan: the same rows, fresh
    assert twin is not plan and (twin.L, twin.offset, twin.generation) == (25, 30, 0)


def test_row_plan_rejects_other_ids():
    """The per-step checks: int32 1-D ids on the plan's device; the plan's
    rows checked once, when it is made."""
    plan = RowPlan(10, "cpu")
    with pytest.raises(TypeError, match="int32"):
        group_rows(torch.zeros(3, dtype=torch.int64), plan)
    with pytest.raises(ValueError, match="rows"):
        RowPlan(10, "cpu", 2 ** 31 - 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["every_other", "outside"])
def test_row_sum_plain_adds_in_position_order(kind, dtype):
    """Each row: its positions' rows added one by one in float32, in
    position order, rounded once to the rows' type; 0 where no id names it."""
    rng = np.random.default_rng(11)
    ids, rows, offset = _case(kind, rng)
    src = rng.standard_normal((len(ids), 5)).astype(np.float32)
    src_t = torch.from_numpy(src).to(dtype)
    got = row_sum(src_t, torch.from_numpy(ids),
                  group_rows(torch.from_numpy(ids), RowPlan(rows, "cpu", offset)))
    want = np.zeros((rows, 5), np.float32)
    wide = src_t.float().numpy()
    for r, positions in _reference(ids, rows, offset):
        for p in positions:
            want[r] += wide[p]
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
