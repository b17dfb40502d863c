#!/usr/bin/env python3
"""B11's grouping of a DMF step's ids and B11's results, beside an earlier
design, and B12 at phase 8's shapes beside it.

Builds ``chip_smoke.py`` phase 7's DMF model (the dense pair, DTCDR's
published width) and its first BOTH step's ids, 8,192 pairs a domain, so
16,384 user ids and 16,384 item ids, and the tower tables' ids, every
target user and every target item. For each checkout it groups both sides'
ids as its DMF does: one ``group_rows`` launch for both sides on the
model's two kept ``RowPlan``s (or, in a checkout that still has it, one
``rating_vector_plan`` launch a side), and times that on the card (calls
queued behind a spin kernel, ``chip_smoke.py::device_ms``) and per call on
the host (back-to-back calls on the host's clock, the device behind them).
It prints the route ``group_rows`` takes (the inboxes up to 16,384 ids a
grouping, else the four rounds). From that grouping it runs B11's forward
on the four histories and the backward into each table, on tables and
gradients drawn from one seed, in float32 and in bfloat16, at the step's
ids and the tower tables' ids, prints a SHA-256 digest of every output's
bytes, and times the source item side's forward and backward at the step,
by kernel too (a profiler trace), and again with the grouping's heads
renumbered in row order; in this checkout also B11's forward built with
its first cut's walk (``B11_VARIANTS``). Then B12 on tables of phase 8's
DCDCSR shapes (8,970 rest rows, two in three all zero, against 2,001
overlapped rows, D 64, k 10) drawn from one seed: its outputs' digests and
its time. In this checkout also B12's split by kernel, its launch at every
count of column ranges from 1 to 8, the variants of
``csrc/benchmark_topk.cu`` in ``B12_VARIANTS`` (parts cut; timed, their
results not used) and the screen's phases by the SMs' clock
(``B12_TIMERS``).

With ``--parent DIR`` (a checkout of an earlier design, for example a
``git archive`` of the parent commit unpacked under ``build/``), the probe
runs in four child processes, DIR, this checkout, this checkout, DIR, each
importing its own checkout's package, ``chip_smoke.py`` and build
directory, and then says whether every output of this checkout is bit-equal
to DIR's. Run from the repository root on a machine with one NVIDIA GPU:

    python3 probe_b11_plan.py [--parent DIR]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: phase 8's DCDCSR tables at BOTH entry: rest rows, overlapped rows, D, k
B12_SHAPE = (8970, 2001, 64, 10)
#: the merge-and-blend launch cut from every variant below but the "merge"
#: ones, which cut the screen's launch instead: they time the screen alone,
#: or the merge alone
B12_MERGE_CUT = ("  merge_blend_kernel<K><<<", "  if (false) merge_blend_kernel<K><<<")
B12_SCREEN_CUT = ("  if (n_rows > 0) {  // the lists' room: 64 for k <= 16, else 96",
                  "  if (false) {")
#: variants of ``csrc/benchmark_topk.cu`` timed beside it (results not
#: used): name -> (line, replacement) pairs
B12_VARIANTS = {
    "screen alone": (),
    # the two small 3xTF32 terms cut, leaving hi*hi (one TF32 product a term)
    "small terms cut": (
        ("        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);",
         "        for (int nt = 0; nt < kNT; ++nt) (void)al[mt][0];"),
        ("        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);",
         "        for (int nt = 0; nt < kNT; ++nt) (void)bl[nt][0];")),
    # no candidate passes a tile's test: the products, staging and norms alone
    "tests cut": (("            if (j < hi && !better(bar_v, bar_i, keys(sx[u1], ee, mx[u1]).y, j)) pass |= 1u << u;",
                   "            if (false) pass |= 1u << u;"),),
    # candidates tested in a range's first tile only
    "tests after the first tile cut": (
        ("            if (j < hi && !better(bar_v, bar_i, keys(sx[u1], ee, mx[u1]).y, j)) pass |= 1u << u;",
         "            if (tile == 1 && j < hi && !better(bar_v, bar_i, keys(sx[u1], ee, mx[u1]).y, j))\n"
         "              pass |= 1u << u;"),),
    # the first tile's bar (the k-th best of its lower keys) not set
    "first-tile bar cut": (
        ("    if (tile == 1) {  // the range's first tile sets the bar: the k-th best of its lower keys",
         "    if (false) {"),),
    "merge alone": (),
    # the merge's k rounds cut
    "merge alone with its rounds cut": (
        ("    for (int r = 0; r < k; ++r) {\n      float bv = -INFINITY;\n      int bi = INT_MAX, bp = -1;",
         "    if (lane < k) {\n      sv[lane] = 0.f;\n      si[lane] = lane;\n    }\n"
         "    for (int r = 0; r < 0; ++r) {\n      float bv = -INFINITY;\n      int bi = INT_MAX, bp = -1;"),),
    # the blend's loop over D cut
    "merge alone with its blend cut": (("  for (int d = lane; d < D; d += 32) {\n    float x[K];",
                                        "  for (int d = lane; d < 0; d += 32) {\n    float x[K];"),),
    # one block an SM: registers unbounded by a second
    "one block an SM": (("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),),
    # the lists' chains cut
    "chains cut": (("  for (int f = lane; f < n_listed; f += 32) {",
                    "  for (int f = lane; f < 0; f += 32) {"),),
    # a row whose list outgrew its room marked (value -1e30), not rescored
    "whole-range rescoring cut": (
        ("    for (int j0 = lo; j0 < hi; j0 += 32) {\n",
         "    mv = -1e30f;\n    mi = 0;\n    for (int j0 = lo; j0 < lo; j0 += 32) {\n"),),
}


def digest(t):
    """SHA-256 (16 hex digits) of a tensor's bytes."""
    import torch

    raw = t.detach().contiguous().view(torch.uint8) if t.dtype != torch.bool else t
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def host_ms(fn, reps=200):
    """Host milliseconds a call takes to return, calls back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return out


#: the B11 forward variants, name -> (line, replacement) pairs: the
#: grouping's heads walked in its own order, a warp a head, each piece of a
#: long row checked for a head first (the first cut of this design)
B11_VARIANTS = {"heads in grouping order and pieces checked": (
    ("  const int total = R + n_pieces;",
     "  const int H = __ldg(gr.meta + 1), total = H + n_pieces;"),
    ("    if (w < R) {\n"
     "      const int r = w, h = head_of(gr, r);\n"
     "      // absent, or a long row: the pieces and combine_kernel\n"
     "      if (h < 0 || p_first[r + 1] > p_first[r]) continue;\n"
     "      const int lo = ptr[r], hi = ptr[r + 1];\n"
     "      const int q0 = gr.head_start[h], q1 = q0 + gr.head_len[h];",
     "    if (w < H) {\n"
     "      const int r = gr.head_row[w];\n"
     "      if (p_first[r + 1] > p_first[r]) continue;\n"
     "      const int lo = ptr[r], hi = ptr[r + 1];\n"
     "      const int q0 = gr.head_start[w], q1 = q0 + gr.head_len[w];"),
    ("      const int p = w - R, r = p_row[p];\n",
     "      const int p = w - H, r = p_row[p];\n      if (head_of(gr, r) < 0) continue;\n"))}


def b11_variants(cs, build, b11, csr, x, ids, grouping, want):
    """{name: (bit-equal to ``want``, a digest of this checkout's forward;
    ms)} of B11's forward from each of ``B11_VARIANTS``."""
    source = open(os.path.join(build.CSRC_DIR, "rating_vector.cu")).read()
    texts = {}
    for name, cuts in B11_VARIANTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f"csrc/rating_vector.cu no longer holds the probe's mark {old!r} once")
            text = text.replace(old, new)
        texts[name.replace(" ", "_")] = text
    fns = build.build_variants("rating_vector", "rating_vector_forward", texts, "probe_b11_plan")
    lib = build._libs["rating_vector"]
    out = {}
    for name in B11_VARIANTS:
        class Variant:
            rating_vector_forward = fns[name.replace(" ", "_")]
            rating_vector_backward = lib.rating_vector_backward

        build._libs["rating_vector"] = Variant()
        try:
            got = digest(b11.rating_vector_forward(csr, x, ids, grouping))
            ms = cs.device_ms(lambda: b11.rating_vector_forward(csr, x, ids, grouping), 50)[0]
        finally:
            build._libs["rating_vector"] = lib
        out[name] = (got == want, ms)
    return out


def fmt_split(split):
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))


def b11_times(cs, b11, csr, x, ids, gout, grouping):
    """B11's forward and backward from one grouping: each call's device ms
    (queued) and its split by kernel (a profiler trace)."""
    fwd = lambda: b11.rating_vector_forward(csr, x, ids, grouping)  # noqa: E731
    bwd = lambda: b11.rating_vector_backward(  # noqa: E731
        csr, x.shape[0], ids, gout, x.dtype, grouping)
    return {"forward": cs.device_ms(fwd, 50)[0], "backward": cs.device_ms(bwd, 50)[0],
            "forward kernels": cs.kernel_split(fwd), "backward kernels": cs.kernel_split(bwd)}


def in_row_order(row_groups, groups):
    """A copy of a card's grouping with its heads renumbered in row order (as
    the earlier design's plan listed them): for timing the order's effect."""
    import torch

    H, n_big = int(groups.meta[1]), int(groups.meta[2])
    buf = groups.buf.clone()
    out = row_groups.Groups(groups.R, groups.L, groups.offset, buf, groups.row_head.clone(),
                            groups.stride)
    order = torch.argsort(groups.head_row[:H])
    rank = torch.empty_like(order)
    rank[order] = torch.arange(H, device=order.device)
    for field in ("head_row", "head_start", "head_len"):
        getattr(out, field)[:H] = getattr(groups, field)[:H][order]
    out.big[:n_big] = rank[groups.big[:n_big].long()].to(torch.int32)
    out.row_head[out.head_row[:H].long()] = torch.arange(H, dtype=torch.int32,
                                                         device=order.device)
    return out


def worker(root, out_path, variants):
    """Run this process's checkout (``root``): print its lines and write its
    digests to ``out_path``; with ``variants``, B12's launch variants too."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.models.dtcdr import _TABLES, DTCDR
    from recbole_cdr_tpu_torch.ops import benchmark_topk as b12
    from recbole_cdr_tpu_torch.ops import build
    from recbole_cdr_tpu_torch.ops import rating_vector as b11
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    if not torch.cuda.is_available():
        sys.exit("probe_b11_plan.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    tag = os.path.basename(os.path.normpath(root)) or root
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{tag}] card: {smi}", flush=True)
    cs.gen_data()
    config = CDRConfig(model="DTCDR", config_dict=cs.dtcdr_config("DMF", "uniform 100", 1),
                       _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    model = DTCDR(config, dataset).to(dev)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(3, dev), dev)
    xs = loop._build_xs(loop._shuffle_material(0), 0, 0, 1)
    step = (torch.cat([xs["source_user_id"][0], xs["target_user_id"][0]]).to(torch.int32),
            torch.cat([xs["source_item_id"][0], xs["target_item_id"][0]]).to(torch.int32))
    tower = (torch.arange(model.target_num_users, dtype=torch.int32, device=dev),
             torch.arange(model.target_num_items, dtype=torch.int32, device=dev))
    new = not hasattr(b11, "rating_vector_plan")
    if new:
        from recbole_cdr_tpu_torch.ops import row_groups

        plans = model._row_plans(dev)

        def group(users, items):
            return row_groups.group_rows(users, plans[0], second=(items, plans[1]))
    else:
        def group(users, items):
            return (b11.rating_vector_plan(users, model.total_num_users),
                    b11.rating_vector_plan(items, model.total_num_items))

    out = {}
    g = torch.Generator(device=dev).manual_seed(11)
    sides = {"user": ("s_items", "t_items"), "item": ("s_users", "t_users")}
    tables = {n: 0.3 * torch.randn(getattr(model, _TABLES[n]).shape, device=dev, generator=g)
              for names in sides.values() for n in names}
    for shape, (users, items) in (("step", step), ("tower", tower)):
        ms, how = cs.device_ms(lambda: group(users, items), 50)
        host = host_ms(lambda: group(users, items))
        route = ""
        if new:
            route = ", route " + ("inboxes" if max(users.shape[0], items.shape[0])
                                  <= row_groups.INBOX_IDS else "four rounds")
        print(f"[{tag}] plan of the {shape}'s ids ({users.shape[0]} users, {items.shape[0]} "
              f"items): {'one group_rows launch' if new else 'two rating_vector_plan launches'} "
              f"{ms:.4f} ms ({how}), host {host:.4f} ms a call{route}", flush=True)
        out[f"plan {shape} ms"], out[f"plan {shape} host ms"] = ms, host
        grouped = dict(zip(sides, group(users, items)))
        for side, ids in (("user", users), ("item", items)):
            gout = torch.randn(ids.shape[0], tables[sides[side][0]].shape[1], device=dev,
                               generator=g)
            for name in sides[side]:
                csr = model._csr(name)
                for dtype in (torch.float32, torch.bfloat16):
                    x = tables[name].to(dtype)
                    fwd = b11.rating_vector_forward(csr, x, ids, grouped[side])
                    bwd = b11.rating_vector_backward(csr, x.shape[0], ids, gout, dtype,
                                                     grouped[side])
                    key = f"{shape} {name} {str(dtype)[6:]}"
                    out[f"forward {key}"], out[f"backward {key}"] = digest(fwd), digest(bwd)
                    if shape == "step" and name == "s_users":
                        times = b11_times(cs, b11, csr, x, ids, gout, grouped[side])
                        print(f"[{tag}] B11 [{key}]: " + ", ".join(
                            f"{k} {v:.4f} ms" if isinstance(v, float) else
                            f"{k} split {fmt_split(v)}" for k, v in times.items()), flush=True)
                        out[f"forward {key} ms"] = times["forward"]
                        out[f"backward {key} ms"] = times["backward"]
                        if new and variants:
                            for vname, (same, ms) in b11_variants(
                                    cs, build, b11, csr, x, ids, grouped[side],
                                    out[f"forward {key}"]).items():
                                print(f"[{tag}] B11 [{key}], {vname}: forward {ms:.4f} ms "
                                      f"({'bit-equal' if same else 'DIFFERS'})", flush=True)
                        if new:  # the same grouping with its heads in row order
                            rowwise = in_row_order(row_groups, grouped[side])
                            assert digest(b11.rating_vector_forward(csr, x, ids, rowwise)) == \
                                out[f"forward {key}"]
                            assert digest(b11.rating_vector_backward(
                                csr, x.shape[0], ids, gout, dtype, rowwise)) == \
                                out[f"backward {key}"]
                            times = b11_times(cs, b11, csr, x, ids, gout, rowwise)
                            print(f"[{tag}] B11 [{key}], heads in row order (bit-equal): "
                                  + ", ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else
                                              f"{k} split {fmt_split(v)}"
                                              for k, v in times.items()), flush=True)
    print(f"[{tag}] B11 digests at the step's and the tower tables' ids: "
          + ", ".join(f"{k} {v}" for k, v in out.items() if not k.endswith(" ms")), flush=True)

    M, n_ov, D, k = B12_SHAPE
    gb = torch.Generator(device=dev).manual_seed(12)
    rest = 0.3 * torch.randn(M, D, device=dev, generator=gb)
    rest[torch.arange(M, device=dev) % 3 != 0] = 0.0
    src = 0.3 * torch.randn(n_ov, D, device=dev, generator=gb)
    s_pop = torch.randint(0, 5, (n_ov,), device=dev, generator=gb).float()
    t_pop = torch.randint(0, 5, (M,), device=dev, generator=gb).float()
    args = (rest, src, s_pop, t_pop, k)
    res = b12.benchmark_topk(*args)
    for name, t in zip(("out", "idx", "sim"), res):
        out[f"b12 {name}"] = digest(t.nan_to_num(7.0) if t.is_floating_point() else t)
    out["b12 ms"] = cs.device_ms(lambda: b12.benchmark_topk(*args), 50)[0]
    print(f"[{tag}] B12 [{M}, {D}] against [{n_ov}, {D}], k {k}: {out['b12 ms']:.4f} ms; "
          f"digests out {out['b12 out']}, idx {out['b12 idx']}, sim {out['b12 sim']}", flush=True)
    if variants:
        b12_variants(cs, build, b12, args, res)
    with open(out_path, "w") as f:
        json.dump(out, f)


#: the screen's phases timed by the SMs' clock (a variant; clock64 around the
#: tiles' tests, the lists' prunes within them, and the rows' final prune,
#: rescoring and top k), summed over warps into five 64-bit counters past
#: the candidates' scratch: all cycles, tests, prunes, final, prunes counted
B12_TIMERS = (
    ("  const int tr = tid >> 2, tq = tid & 3;\n",
     "  const int tr = tid >> 2, tq = tid & 3;\n"
     "  long long T0 = clock64(), t_ep = 0, t_mg = 0, t_fin = 0, n_mg = 0, te0 = 0;\n"),
    ("    // ---- the tile's scores are complete: to shared memory, then tested ----\n",
     "    // ---- the tile's scores are complete: to shared memory, then tested ----\n"
     "    te0 = clock64();\n"),
    ("    if (__any_sync(0xffffffffu, full)) {  // lists too full: pruned by their groups, tested again\n",
     "    const long long tm = clock64();\n"
     "    if (__any_sync(0xffffffffu, full)) {  // lists too full: pruned by their groups, tested again\n"
     "      ++n_mg;\n"),
    ("    }\n    const int listed = S.n[tr];\n",
     "    }\n    t_mg += clock64() - tm;\n    const int listed = S.n[tr];\n"),
    ("    if (!full && tq == 0) S.n[tr] = listed + row_n;\n  }\n",
     "    if (!full && tq == 0) S.n[tr] = listed + row_n;\n    t_ep += clock64() - te0;\n  }\n"),
    ("  cp_wait<0>();\n  __syncthreads();\n\n",
     "  cp_wait<0>();\n  __syncthreads();\n  const long long tf0 = clock64();\n\n"),
    ("      part_idx[at + lane] = lane < k ? mi : INT_MAX;\n    }\n  }\n}\n",
     "      part_idx[at + lane] = lane < k ? mi : INT_MAX;\n    }\n  }\n"
     "  t_fin = clock64() - tf0;\n"
     "  if (lane == 0) {\n"
     "    unsigned long long* T = (unsigned long long*)(part_val + (long long)gridDim.y * M * K);\n"
     "    atomicAdd(T, clock64() - T0);\n    atomicAdd(T + 1, t_ep);\n"
     "    atomicAdd(T + 2, t_mg);\n    atomicAdd(T + 3, t_fin);\n    atomicAdd(T + 4, n_mg);\n"
     "  }\n}\n"),
)


def listed_rows(build, rest):
    """(nonzero, rows, n_rows): B12's list of the rest rows that hold a
    value other than 0 (``benchmark_topk_rows``)."""
    import torch

    M, D = rest.shape
    nonzero = torch.empty(M, dtype=torch.int32, device=rest.device)
    rows = torch.empty(M, dtype=torch.int32, device=rest.device)
    count = torch.empty(1, dtype=torch.int32, device=rest.device)
    build.check(build.library("benchmark_topk").benchmark_topk_rows(
        rest.data_ptr(), M, D, nonzero.data_ptr(), rows.data_ptr(), count.data_ptr(),
        build.stream_handle(rest)), "benchmark_topk_rows")
    return nonzero, rows, int(count.item())


def b12_timers(cs, build, b12, args, splits):
    """Print the screen's phases by the SMs' clock (``B12_TIMERS``) at
    ``splits`` column ranges: cycles a warp, averaged over the launch's."""
    import torch

    rest, src, s_pop, t_pop, k = args
    M, D = rest.shape
    n_ov = src.shape[0]
    width = 16 if k <= 16 else 32
    text = open(os.path.join(build.CSRC_DIR, "benchmark_topk.cu")).read()
    for old, new in B12_TIMERS + (B12_MERGE_CUT,):
        if text.count(old) != 1:
            sys.exit(f"csrc/benchmark_topk.cu no longer holds the probe's mark {old!r} once")
        text = text.replace(old, new)
    fn = build.build_variants("benchmark_topk", "benchmark_topk", {"timers": text},
                              "probe_b11_plan")["timers"]
    tiles = -(-n_ov // b12.COLS)
    per = -(-tiles // splits)
    span, splits = per * b12.COLS, -(-tiles // per)
    part_v = torch.zeros(splits * M * width + 16, device=rest.device)
    part_i = torch.empty(splits * M * width, dtype=torch.int32, device=rest.device)
    got = (torch.empty_like(rest), torch.empty(M, k, dtype=torch.int32, device=rest.device),
           torch.empty(M, k, device=rest.device))
    nonzero, rows, n_rows = listed_rows(build, rest)
    build.check(fn(rest.data_ptr(), src.data_ptr(), s_pop.data_ptr(), t_pop.data_ptr(), M,
                   nonzero.data_ptr(), rows.data_ptr(), n_rows, n_ov, D, k, splits, span,
                   part_v.data_ptr(), part_i.data_ptr(), *(t.data_ptr() for t in got),
                   build.stream_handle(rest)), "timers")
    torch.cuda.synchronize()
    T = part_v[splits * M * width:splits * M * width + 10].view(torch.int64).tolist()
    warps = -(-n_rows // b12.ROWS) * splits * 8
    names = ("all", "tests", "prunes in tests", "final", "prunes")  # a warp's
    print(f"B12 screen by the clock at {splits} ranges (a warp's mean cycles): "
          + ", ".join(f"{n} {v / warps:.0f}" for n, v in zip(names, T)), flush=True)


def b12_variants(cs, build, b12, args, res):
    """B12's C entry at every count of column ranges (results held equal),
    its split by kernel, and ``B12_VARIANTS``, each with its merge launch
    cut, at one range and at the plan's count (timed only; the rows that
    outgrew their kept lists counted)."""
    import torch

    rest, src, s_pop, t_pop, k = args
    M, D = rest.shape
    n_ov = src.shape[0]
    width = 16 if k <= 16 else 32
    source = open(os.path.join(build.CSRC_DIR, "benchmark_topk.cu")).read()
    texts = {}
    for name, cuts in B12_VARIANTS.items():
        text = source
        for old, new in cuts + ((B12_SCREEN_CUT,) if name.startswith("merge alone")
                                else (B12_MERGE_CUT,)):
            if text.count(old) != 1:
                sys.exit(f"csrc/benchmark_topk.cu no longer holds the probe's mark {old!r} once")
            text = text.replace(old, new)
        texts[name.replace(" ", "_")] = text
    built = build.build_variants("benchmark_topk", "benchmark_topk", texts, "probe_b11_plan")
    fns = {"kernel": build.library("benchmark_topk").benchmark_topk,
           **{name: built[name.replace(" ", "_")] for name in B12_VARIANTS}}
    tiles = -(-n_ov // b12.COLS)
    nonzero, rows, n_rows = listed_rows(build, rest)
    planned = b12.benchmark_topk_plan(
        n_rows, n_ov, k, torch.cuda.get_device_properties(rest.device).multi_processor_count)[0]
    print(f"B12 split by kernel: {fmt_split(cs.kernel_split(lambda: b12.benchmark_topk(*args)))}"
          f" (ms a call; {n_rows} of {M} rows listed, the plan's {planned} ranges)", flush=True)
    line = []
    for name, fn in fns.items():
        for splits in range(1, b12.MAX_SPLITS + 1):
            per = -(-tiles // splits)
            if -(-tiles // per) != splits or (name != "kernel" and splits not in (1, planned)):
                continue
            span = per * b12.COLS
            part_v = torch.empty(splits, M, width, device=rest.device)
            part_i = torch.empty(splits, M, width, dtype=torch.int32, device=rest.device)
            got = (torch.empty_like(rest), torch.empty(M, k, dtype=torch.int32,
                                                       device=rest.device),
                   torch.empty(M, k, device=rest.device))

            def launch(fn=fn, splits=splits, span=span, part_v=part_v, part_i=part_i, got=got):
                build.check(fn(rest.data_ptr(), src.data_ptr(), s_pop.data_ptr(),
                               t_pop.data_ptr(), M, nonzero.data_ptr(), rows.data_ptr(), n_rows,
                               n_ov, D, k, splits, span, part_v.data_ptr(), part_i.data_ptr(),
                               *(t.data_ptr() for t in got), build.stream_handle(rest)), name)
            launch()
            torch.cuda.synchronize()
            if name == "kernel":
                assert torch.equal(got[1], res[1]) and torch.equal(got[2], res[2]), splits
            extra = ""
            if name == "whole-range rescoring cut":
                extra = f" ({int((part_v[:, :, 0] == -1e30).sum())} row ranges outgrew their lists)"
            line.append(f"{name} at {splits} ranges {cs.device_ms(launch, 50)[0]:.4f}{extra}")
    print("B12 variants (ms): " + ", ".join(line), flush=True)
    for splits in sorted({1, planned}):
        b12_timers(cs, build, b12, args, splits)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier design to run in turns")
    ap.add_argument("--root", help=argparse.SUPPRESS)  # a child's checkout
    ap.add_argument("--out", help=argparse.SUPPRESS)  # a child's digests
    args = ap.parse_args()
    outdir = os.path.join(HERE, "build", "probe_b11_plan")
    os.makedirs(outdir, exist_ok=True)
    if args.root or not args.parent:
        root = os.path.abspath(args.root or HERE)
        worker(root, args.out or os.path.join(outdir, "this.json"), root == HERE)
        return 0
    parent = os.path.abspath(args.parent)
    runs = []
    for turn, root in enumerate((parent, HERE, HERE, parent)):
        path = os.path.join(outdir, f"turn{turn}.json")
        env = dict(os.environ, PYTHONPATH=root)
        env.pop("RECBOLE_CDR_TORCH_BUILD_DIR", None)  # each checkout builds into its own
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, "--out", path],
                       cwd=root, env=env, check=True)
        with open(path) as f:
            runs.append(json.load(f))
    keys = [k for k in runs[0] if not k.endswith(" ms")]
    differ = [k for k in keys if len({r[k] for r in runs}) != 1]
    print(f"bit-equal to the parent's in every turn: {len(keys) - len(differ)} of {len(keys)} "
          f"outputs" + (f"; differ: {differ}" if differ else ""), flush=True)
    for k in runs[0]:
        if k.endswith(" ms"):
            print(f"{k}: parent {runs[0][k]:.4f} / {runs[3][k]:.4f}, this {runs[1][k]:.4f} / "
                  f"{runs[2][k]:.4f}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
