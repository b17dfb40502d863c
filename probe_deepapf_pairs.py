#!/usr/bin/env python3
"""Where B16's training kernels (DeepAPF's step) spend their time.

Times the forward and the three launches of the backward of
``recbole_cdr_tpu_torch/csrc/deepapf_attention.cu`` (the pair kernel, the
plan of the step's keys, ``ops/row_groups.py::group_rows``, and the tables
kernel) at the first training step of ``chip_smoke.py``'s dense pair (the
ids phase 2 holds B16 at, and phase 11's DeepAPF trains on): D 64, both
domains' 16,384 pairs, the items the entity (their tables' rows
``num_total_item``), the users the other side; random tables and weights,
in float32 and in bfloat16. Beside them, variants of the source built for
this probe (``ops/build.py::build_variants``): the pair kernels with one row
buffer (no ``cp.async`` of the next unit or tile while one computes), the
forward with 8 pairs a warp (float32's unit is 16 up to D = 64) with two
buffers and with one, the
backward's pair kernel without its dW stage and without its dx product, and
the tables kernel without its zero pass, with its zero pass alone, without
its long rows (a block's), with them alone, with its heads and zero passes
in opposite orders on odd and even blocks, with a long row's segments of
64 terms in place of 32, with 1 or 3 blocks a multiprocessor in place of
2, and with 4 or 16 rows in flight a lane in place of 8. Prints one line a
type and a line of the plan's heads. Run from the repository root on a
machine with one NVIDIA GPU (~3 min with the build):

    python3 probe_deepapf_pairs.py
"""

import os
import sys

D = 64

#: the tables kernel's calls of its passes
PASSES = "  long_rows();\n  heads_pass();\n  zero_pass();"
#: (entry, name, [(text, replacement), ...]): the variants, each a set of
#: replacements of the source's text (every occurrence)
CUTS = (
    ("deepapf_forward", "forward one buffer",
     [("static constexpr int NBUF = FIXED + 2 * kWarps * BUF <= (size_t)kMaxSmem ? 2 : 1;",
       "static constexpr int NBUF = 1;")]),
    ("deepapf_forward", "forward 8 pairs a warp",
     [("  static constexpr int MT = G::MT;\n  static constexpr int UNIT",
       "  static constexpr int MT = 1;\n  static constexpr int UNIT")]),
    ("deepapf_forward", "forward 8 pairs a warp one buffer",
     [("  static constexpr int MT = G::MT;\n  static constexpr int UNIT",
       "  static constexpr int MT = 1;\n  static constexpr int UNIT"),
      ("static constexpr int NBUF = FIXED + 2 * kWarps * BUF <= (size_t)kMaxSmem ? 2 : 1;",
       "static constexpr int NBUF = 1;")]),
    ("deepapf_backward", "pairs one buffer",
     [("static constexpr int NBUF = bwd_bytes<D, T>(PW, 2) <= kMaxSmem ? 2 : 1;",
       "static constexpr int NBUF = 1;")]),
    ("deepapf_backward", "pairs without dW",
     [("    // dW += x^T dZ over the tile's rows", "#if 0\n"),
      ("    __syncthreads();  // the rows and dZ are restaged next",
       "#endif\n    __syncthreads();")]),
    ("deepapf_backward", "pairs without dx",
     [("#pragma unroll 2\n      for (int j = 0; j < NT; ++j) {\n        const float a[4]",
       "#pragma unroll 2\n      for (int j = 0; j < 0; ++j) {\n        const float a[4]")]),
    ("deepapf_backward_tables", "tables zeros alone", [(PASSES, "  zero_pass();")]),
    ("deepapf_backward_tables", "tables without zeros",
     [(PASSES, "  long_rows();\n  heads_pass();")]),
    ("deepapf_backward_tables", "tables without long rows",
     [(PASSES, "  heads_pass();\n  zero_pass();")]),
    ("deepapf_backward_tables", "tables long rows alone", [(PASSES, "  long_rows();")]),
    ("deepapf_backward_tables", "tables alternating passes",
     [(PASSES, "  long_rows();\n  if (bid & 1) zero_pass(), heads_pass();\n"
               "  else heads_pass(), zero_pass();")]),
    ("deepapf_backward_tables", "tables segments of 64",
     [("constexpr int kSegTerms = 32;", "constexpr int kSegTerms = 64;")]),
    ("deepapf_backward_tables", "tables 1 block",
     [("constexpr int kTablesBlocks = 2;", "constexpr int kTablesBlocks = 1;")]),
    ("deepapf_backward_tables", "tables 3 blocks",
     [("constexpr int kTablesBlocks = 2;", "constexpr int kTablesBlocks = 3;")]),
    ("deepapf_backward_tables", "tables 4 in flight",
     [("add_terms<4, 8, false>", "add_terms<4, 4, false>")]),
    ("deepapf_backward_tables", "tables 16 in flight",
     [("add_terms<4, 8, false>", "add_terms<4, 16, false>")]),
)


def variants(build):
    """{(entry, name): the variant's entry}, all built at once."""
    src = open(os.path.join(build.CSRC_DIR, "deepapf_attention.cu")).read()
    by_entry = {}
    for entry, name, edits in CUTS:
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"the kernel source no longer holds the text {name!r} cuts")
            text = text.replace(old, new)
        by_entry.setdefault(entry, {})[name.replace(" ", "_")] = text
    out = {}
    for entry, texts in by_entry.items():
        fns = build.build_variants("deepapf_attention", entry, texts, "pairs_probe_" + entry)
        out.update({(entry, k.replace("_", " ")): f for k, f in fns.items()})
    return out


def step_ids(dev):
    """(pairs, entity rows N, other rows M, the overlapped count) of the
    first training step of ``chip_smoke.py``'s dense pair, the items the
    entity."""
    import torch

    from chip_smoke import config_dict, gen_data
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.ops.deepapf_attention import Pairs
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    gen_data()
    config = CDRConfig(model="CMF", config_dict=config_dict(), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(0, dev), dev)
    xs = loop._build_xs(loop._shuffle_material(0), 0, 0, 1)
    pairs = Pairs(*(xs[f"{d}_{f}_id"][0].to(torch.int32).contiguous()
                    for d in ("source", "target") for f in ("item", "user")))
    return pairs, dataset.num_total_item, dataset.num_total_user, dataset.num_overlap_item


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from chip_smoke import device_ms
    from recbole_cdr_tpu_torch.ops import build, row_groups
    from recbole_cdr_tpu_torch.ops import deepapf_attention as b16

    dev = torch.device("cuda")
    build.build_all()
    cuts = variants(build)
    lib = build.library("deepapf_attention")
    pairs, N, M, OVERLAPPED = step_ids(dev)
    gd = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device=dev, generator=gd)
    tabs32 = b16.Tables(*(rnd(N, D, scale=0.3) for _ in range(3)),
                        *(rnd(M, D, scale=0.3) for _ in range(2)))
    w32 = b16.Weights(rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1), rnd(D, 1, scale=0.3),
                      rnd(D, 1, scale=0.3))
    P = pairs.ent_src.shape[0] + pairs.ent_tgt.shape[0]
    gz = torch.randn(P, device=dev, generator=gd)
    for dt in (torch.float32, torch.bfloat16):
        tabs = b16.Tables(*(t.to(dt) for t in tabs32))
        w = b16.Weights(*(t.to(dt) for t in w32))
        gv = gz.to(dt)
        tables, ids, ws, n_src, n = b16._operands(tabs, pairs, w)
        code, stream = build.DTYPES[dt], build.stream_handle(gv)
        blocks = lib.deepapf_backward_blocks(D, n, code)
        rows = torch.empty(3, n, D, device=dev)
        keys = torch.empty(2, n, dtype=torch.int32, device=dev)
        partial = torch.empty(max(blocks, 1), D * D + 3 * D, device=dev)
        logits = torch.empty(n, dtype=dt, device=dev)
        grads = [torch.empty(t.shape, dtype=dt, device=dev) for t in tables]
        flat = torch.empty(D * D + 3 * D, dtype=dt, device=dev)
        at, ai, ag = b16._addresses(tables), b16._addresses(ids), b16._addresses(grads)
        wp = [x.data_ptr() for x in ws]

        def forward(fn=lib.deepapf_forward):
            build.check(fn(at, ai, n_src, n, OVERLAPPED, *wp, D, logits.data_ptr(), code,
                           stream), "forward")

        def pair_kernel(fn=lib.deepapf_backward):
            build.check(fn(at, ai, n_src, n, N, M, OVERLAPPED, *wp, D, gv.data_ptr(),
                           rows.data_ptr(), keys.data_ptr(), partial.data_ptr(), blocks, code,
                           stream), "pair kernel")

        plans = (b16._plan(dev, 2 * N, 0, n), b16._plan(dev, 2 * M, 1, n))
        pair_kernel()

        def plan():
            return row_groups.group_rows(keys[0], plans[0], second=(keys[1], plans[1]))

        ge, go = plan()

        def tables_kernel(fn=lib.deepapf_backward_tables):
            build.check(fn(partial.data_ptr(), blocks, flat.data_ptr(), rows.data_ptr(), n, D,
                           ge.pointers(), go.pointers(), ag, N, M, code, stream), "tables")

        times = {"forward": forward, "pair kernel": pair_kernel, "plan": plan,
                 "tables kernel": tables_kernel,
                 "backward": lambda: b16.deepapf_backward(tabs, pairs, OVERLAPPED, w, gv)}
        launch = {"deepapf_forward": forward, "deepapf_backward": pair_kernel,
                  "deepapf_backward_tables": tables_kernel}
        for (entry, name), fn in cuts.items():
            times[name] = lambda fn=fn, entry=entry: launch[entry](fn)
        ms = {name: device_ms(fn, 20)[0] for name, fn in times.items()}
        print(f"deepapf pairs probe [{dt}, D {D}, {n} pairs, tables {N} / {M}]: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
        if dt == torch.float32:
            for what, grp in (("entity", ge), ("other", go)):
                meta = grp.meta.tolist()
                lens = grp.head_len[:meta[1]]
                print(f"  {what} keys: {meta[1]} heads, {meta[2]} over 64 positions, longest "
                      f"{int(lens.max())}, mean {float(lens.float().mean()):.2f}", flush=True)


if __name__ == "__main__":
    main()
