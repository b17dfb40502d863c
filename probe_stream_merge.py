#!/usr/bin/env python3
"""Device time of B3's epoch streams and of B14's merge, at
``chip_smoke.py`` phase 2's shapes, beside cuts of their sources and, with
``--parent``, beside an earlier design.

Builds phase 2's device loop (CMF on the dense pair, BOTH, one negative)
and times, with no negatives (``neg_num`` 0), each stream's whole
construction as the loop runs it (``DeviceEpochLoop._domain_stream``: the
source stream, cycling, 19 steps of 4,096 slots; the target stream, 19 of
8,192): calls queued behind a spin kernel (``chip_smoke.py::device_ms``,
the device time between the calls' first and last launch, gaps included)
and the summed durations of the kernels a call launches (a
``torch.profiler`` trace, each kernel's name and count printed), and B3's
kernel alone. Then B14's merge (``sharded_topk_merge``) on sorted, tied,
padded lists at phase 4's streaming tile (2,048 rows, k 10) for m of 1, 2
and 4, and an empty kernel (``torch.cuda._sleep(0)``) as the launch floor.
This checkout's kernels are held against their plain versions first; in
this checkout also variants made by replacing lines of ``csrc/shuffle.cu``
and ``csrc/streaming_topk.cu`` (``build.build_variants``): the round's
shifts on the FMA pipe (high halves of products), the partner's wrap by a
sign mask, the swap's select by a predicated move, the rounds cut
(staging, slots, gathers and stores alone), the gathers cut; the merge's
searches cut (a copy of each list's place r).

With ``--parent DIR`` (a checkout of an earlier design, for example a
``git archive`` of the parent commit unpacked under ``build/``), the probe
runs in four child processes, DIR, this checkout, this checkout, DIR, each
importing its own checkout's package, ``chip_smoke.py`` and build
directory, so that both designs are timed on one card in turns.
Run from the repository root on a machine with one NVIDIA GPU:

    python3 probe_stream_merge.py [--parent DIR]
"""

import argparse
import inspect
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: (name, source, entry, cuts): variants of this checkout's kernels, each
#: cut a (line, replacement) pair of the source's text
VARIANTS = (
    ("shifts on the FMA pipe", "shuffle", "swap_or_not",
     (("(x >> 16)", "__umulhi(x, 1u << 16)"), ("(m >> 13)", "__umulhi(m, 1u << 19)"))),
    ("partner by a sign mask", "shuffle", "swap_or_not",
     (("  const uint32_t p = min((uint32_t)(ks.x - v), (uint32_t)ks.y - (uint32_t)v);",
       "  int q = ks.x - v;\n  if (q < 0) q += ks.y - ks.x;\n  const uint32_t p = q;"),)),
    ("rounds cut", "shuffle", "swap_or_not", (("  if (a.n > 1) {", "  if (false) {"),)),
    ("gathers cut", "shuffle", "swap_or_not",
     (("const int2 row = __ldg((const int2*)a.tab + v);", "const int2 row = make_int2(v, v);"),
      ("a.out0[t] = __ldg(a.tab + v);", "a.out0[t] = v;"))),
    ("select by a predicated move", "shuffle", "swap_or_not",
     (("  return (m & 0x10000u) ? (int)p : v;",
       "  asm(\"{\\n .reg .pred q;\\n setp.ne.u32 q, %1, 0;\\n @q mov.b32 %0, %2;\\n}\"\n"
       "      : \"+r\"(v) : \"r\"(m & 0x10000u), \"r\"((int)p));\n  return v;"),)),
    ("searches cut", "streaming_topk", "streaming_topk_merge",
     (("for (int j = 0; j < m - 1; ++j)", "for (int j = 0; j < 0; ++j)"),)),
)


def sorted_lists(m, B, k, dev, seed=21, span=1000):
    """[m, B, k] lists as B14's local stage writes them (``chip_smoke.py::
    check_b14_merge``'s): integer scores in {-3..3}, list j's ids above
    list j - 1's, each row sorted by (score desc, id asc), every third row
    padded with (-inf, INT32_MAX) after a few entries."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randint(-3, 4, (m, B, k), device=dev, generator=g).float()
    ids = torch.rand(m, B, span, device=dev, generator=g).argsort(-1)[..., :k]
    ids = (ids + span * torch.arange(m, device=dev)[:, None, None]).to(torch.int32)
    order = (-s * (span * m) + ids).argsort(-1)
    s, ids = s.gather(-1, order), ids.gather(-1, order)
    rows = torch.arange(B, device=dev)
    pad = torch.arange(k, device=dev)[None, None, :] >= torch.where(
        rows % 3 == 0, rows % (k + 1), k)[None, :, None]
    return s.masked_fill(pad, -torch.inf), ids.masked_fill(pad, 2 ** 31 - 1)


def kernel_split(cs, fn, reps=20):
    """(summed kernel ms a call, {kernel name: launches a call}) from a
    torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(cs.PROFILER_TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = cs._device_events(prof)
        if events:
            break
    names = {}
    for e in events:
        names[e.name[:60]] = names.get(e.name[:60], 0) + 1
    total = sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    return total, {k: v / reps for k, v in names.items()}


def worker(root, variants):
    """Time this process's checkout (``root``) and print its lines; with
    ``variants``, the cuts of its sources too."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.ops import build, shuffle as k3, topk as b5
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    if not torch.cuda.is_available():
        sys.exit("probe_stream_merge.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    tag = os.path.basename(os.path.normpath(root))
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{tag}] card: {smi}", flush=True)
    cs.gen_data()
    config = CDRConfig(model="CMF", config_dict=cs.config_dict(), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(0, dev), dev)
    loop.neg_num = 0
    shuf = loop._shuffle_material(0)
    n_steps = loop.steps_per_epoch
    new_entry = "table" in inspect.signature(k3.swap_or_not).parameters
    timed = {}
    for name, data, dom, dstep, cycle in (("source", loop.src, "src", loop.src_step, True),
                                          ("target", loop.tgt, "tgt", loop.step, False)):
        def stream(data=data, dom=dom, dstep=dstep, cycle=cycle):
            return loop._domain_stream(data, dom, shuf[dom], 0, n_steps, dstep, cycle, 0)

        keys, salts = shuf[dom]
        per_cycle = loop.src_batches_per_cycle if cycle else 0
        if new_entry:
            args = (data.pairs, data.n, keys, salts, 0, n_steps, dstep, per_cycle)
            got = k3.swap_or_not(*args)
            assert all(torch.equal(a, b) for a, b in zip(got, k3.swap_or_not_stream_plain(*args)))

            def kernel(args=args):
                return k3.swap_or_not(*args)
        else:  # the parent's B3: the rounds alone, on the slots the loop builds
            s = torch.arange(n_steps, device=dev)
            c = s // max(per_cycle, 1) if cycle else torch.zeros_like(s)
            slots = ((s % per_cycle) if cycle else s)[:, None] * dstep + torch.arange(
                dstep, device=dev)
            x = torch.where(slots < data.n, slots, 0).to(torch.int32)
            kk, ss = (keys[c], salts[c]) if cycle else (keys, salts)

            def kernel(x=x, kk=kk, ss=ss, n=data.n):
                return k3.swap_or_not(x, n, kk, ss)
        ms = cs.device_ms(stream, 50)[0]
        split_ms, names = kernel_split(cs, stream)
        timed[name] = (ms, split_ms, cs.device_ms(kernel, 50)[0])
        print(f"[{tag}] {name} stream ({n_steps} x {dstep}): a call {ms:.4f} ms queued, its "
              f"kernels {split_ms:.4f} ms ({names}); B3's kernel {timed[name][2]:.4f} ms",
              flush=True)
    B, k = cs.B14_TILE[0], cs.B14_TILE[3]
    lists = {m: sorted_lists(m, B, k, dev) for m in (1, 2, 4)}
    for m, (s, i) in lists.items():
        got, want = b5.sharded_topk_merge(s, i, k), b5.sharded_topk_merge_plain(s, i, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), m
    merge = {m: cs.device_ms(lambda s=s, i=i: b5.sharded_topk_merge(s, i, k), 50)[0]
             for m, (s, i) in lists.items()}
    floor = cs.device_ms(lambda: torch.cuda._sleep(0), 50)[0]
    print(f"[{tag}] merge ({B} rows, k {k}) ms at m 1 / 2 / 4: "
          + " / ".join(f"{v:.4f}" for v in merge.values())
          + f"; empty kernel {floor:.4f} ms", flush=True)
    if not variants:
        return
    fns = {}
    for source in {v[1] for v in VARIANTS}:
        texts = {}
        for name, src, _, cuts in VARIANTS:
            if src != source:
                continue
            text = open(os.path.join(build.CSRC_DIR, source + ".cu")).read()
            for old, new in cuts:
                if text.count(old) != 1:
                    sys.exit(f"csrc/{source}.cu no longer holds the probe's mark {old!r} once")
                text = text.replace(old, new)
            texts[name.replace(" ", "_")] = text
        entry = next(v[2] for v in VARIANTS if v[1] == source)
        fns.update(build.build_variants(source, entry, texts, "probe_stream_merge"))
    for name, source, entry, cuts in VARIANTS:
        fn = fns[name.replace(" ", "_")]
        lib = build._libs[source]

        class Variant:
            pass

        variant = Variant()
        setattr(variant, entry, fn)
        build._libs[source] = variant
        try:
            if source == "shuffle":
                out = []
                for stream_name, data, dom, dstep, per_cycle in (
                        ("source", loop.src, "src", loop.src_step, loop.src_batches_per_cycle),
                        ("target", loop.tgt, "tgt", loop.step, 0)):
                    args = (data.pairs, data.n, *shuf[dom], 0, n_steps, dstep, per_cycle)
                    out.append(f"{stream_name} {cs.device_ms(lambda a=args: k3.swap_or_not(*a), 50)[0]:.4f}")
            else:
                out = [f"m {m} {cs.device_ms(lambda s=s, i=i: b5.sharded_topk_merge(s, i, k), 50)[0]:.4f}"
                       for m, (s, i) in lists.items()]
        finally:
            build._libs[source] = lib
        print(f"[{tag}] variant {name}: " + ", ".join(out) + " ms", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier design to time in turns")
    ap.add_argument("--root", help=argparse.SUPPRESS)  # a child's checkout
    args = ap.parse_args()
    if args.root or not args.parent:
        root = os.path.abspath(args.root or HERE)
        worker(root, root == HERE)
        return 0
    parent = os.path.abspath(args.parent)
    for root in (parent, HERE, HERE, parent):
        env = dict(os.environ, PYTHONPATH=root)
        env.pop("RECBOLE_CDR_TORCH_BUILD_DIR", None)  # each checkout builds into its own
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root], cwd=root,
                       env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
