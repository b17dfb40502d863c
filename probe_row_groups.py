#!/usr/bin/env python3
"""The plan of a step's ids (``group_rows``, ``csrc/row_groups.cu``) beside
variants of its source, and its call's host cost.

Shapes: ``chip_smoke.py`` phase 2's own steps, built from its data the way
phase 2 builds them: the catalog step (B6's first step: both domains' item
ids over the catalog's item rows) and K1's dense step (two groupings in one
launch: a dense step's user ids and item ids); and a NATR TARGET step's
history slots (about 2,100 anchors x 50 slots over 13,000 source rows,
drawn from a power law: the plan that transferring each distinct source row
once per step would need). Each variant's grouping is held against the plain
version through ``canonical``; the device time is the mean of calls queued
behind a spin kernel (``chip_smoke.py::device_ms``). Variants, each the
source with lines replaced: the kernel as built (the inboxes up to
16,384 ids, the four rounds above), every inbox sorted in shared memory
(bitonic) in place of the hash table (``sorted``), the inboxes cut once every key
is in its inbox (``inboxes_routed``: the launch, the routing and the two
cluster barriers), the four rounds at every R (``four_rounds``), and the
four rounds cut after their first one, two and three rounds (where their
time goes). The cuts are not checked. The cut after
three rounds (tickets, claims, placement) is the least that the four rounds
could take if their ranks (round D) went to the plan's consumers or their
tickets came in position order: both still take, claim and place every
occurrence. With ``--parent DIR``, the source of the checkout at DIR (an
earlier design with the same C interface). Then the call: the wrapper on a
kept ``RowPlan`` against the same launch made as a call that allocates its
buffer, builds its C array and its ``Groups`` anew (what a wrapper without a
kept plan does), both with CUDA events around 200 back-to-back calls (the
larger of the device's and the host's time a call), and on the host clock
alone while a spin kernel holds the device (the host's time a call).
Run from the repository root on a machine with one NVIDIA GPU:

    python3 probe_row_groups.py [--parent DIR]
"""

import argparse
import ctypes
import os
import sys

#: the four rounds at every R
FOUR_ROUNDS = ("const bool inboxes = R <= kInboxMax;", "const bool inboxes = false;")
#: (line, replacement) pairs of csrc/row_groups.cu per variant
VARIANTS = {
    "kernel": (),
    "sorted": (("  if (M > kHashMax) {", "  if (M > 0) {"),),
    "inboxes_routed": (("  cluster_barrier(cluster);  // every key is in its inbox\n",
                        "  cluster_barrier(cluster);  // every key is in its inbox\n  return;\n"),),
    "four_rounds": (FOUR_ROUNDS,),
}
#: the four-round kernel's cluster barriers between its rounds
BARRIER = "\n  cluster_barrier(cluster);\n"
#: the four rounds cut after their first k rounds: where their time goes
#: (their groupings are incomplete and not checked)
CUTS = {f"rounds{k}": k for k in (1, 2, 3)}
#: the variants whose groupings are incomplete
UNCHECKED = {"inboxes_routed", *CUTS}


def variant_texts(text):
    """{name: the source of each variant and cut}."""
    out = {}
    for name, swaps in VARIANTS.items():
        out[name] = text
        for old, new in swaps:
            assert text.count(old) == 1, old
            out[name] = out[name].replace(old, new)
    assert text.count(BARRIER) == 3, "the four rounds moved"
    four = out["four_rounds"]
    for name, k in CUTS.items():
        at = -1
        for _ in range(k):
            at = four.index(BARRIER, at + 1)
        at += len(BARRIER)
        out[name] = four[:at] + "  return;\n" + four[at:]
    return out


def power_law(n, rows, alpha, gen, dev):
    """int32 ids in [0, rows), P(id = r) proportional to (r + 1)^-alpha."""
    import torch

    w = torch.arange(1, rows + 1, device=dev, dtype=torch.float64) ** -alpha
    return torch.multinomial(w, n, replacement=True, generator=gen).to(torch.int32)


def phase2_step(dev, cfg, seed, steps=1):
    """(dataset, the first of ``steps`` BOTH steps' id tensors) of the
    configuration ``cfg``, built as ``chip_smoke.py`` phase 2 builds them."""
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    config = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(seed, dev), dev)
    xs = loop._build_xs(loop._shuffle_material(0), 0, 0, steps)
    return dataset, {k: v[0] for k, v in xs.items()}


def shapes(dev, gen):
    """{name: [(ids, rows), ...]} of the probe's groupings."""
    import torch

    import chip_smoke as cs

    cs.gen_data()
    cs.gen_catalog()
    both = lambda xs, side: torch.cat([xs[f"source_{side}_id"], xs[f"target_{side}_id"]]).to(
        torch.int32)
    cdata, cxs = phase2_step(dev, cs.catalog_config(), 1, cs.B6_STEPS)
    data, xs = phase2_step(dev, cs.config_dict(), 0)
    return {
        "catalog step": [(both(cxs, "item"), cdata.num_total_item)],
        "K1 dense step": [(both(xs, "user"), data.num_total_user),
                          (both(xs, "item"), data.num_total_item)],
        "NATR step slots": [(power_law(105_000, 13_000, 0.9, gen, dev), 13_000)],
    }


class Raw:
    """A grouping's buffers at stride R for one library: the ten addresses
    the C entry takes, and the Groups that reads them."""

    def __init__(self, ids, rows):
        import torch

        from recbole_cdr_tpu_torch.ops import row_groups

        self.ids, self.rows, R = ids, rows, ids.shape[0]
        self.scratch = torch.zeros((2, rows), dtype=torch.int32, device=ids.device)
        S = max(R, 1)
        self.buf = torch.empty(4 + 7 * S, dtype=torch.int32, device=ids.device)
        self.groups = row_groups.Groups(R, rows, 0, self.buf, self.scratch[1])
        base, cnt = self.buf.data_ptr(), self.scratch.data_ptr()
        self.ptrs = (ctypes.c_void_p * 10)(cnt, cnt + 4 * rows, base,
                                           *(base + 16 + 4 * S * k for k in range(7)))

    def args(self):
        return (self.ids.data_ptr(), self.ids.shape[0], self.rows, 0,
                ctypes.addressof(self.ptrs))


def launcher(fn, sets, stream):
    raws = [Raw(ids, rows) for ids, rows in sets]
    rest = raws[1].args() if len(raws) > 1 else (None, 0, 0, 0, None)

    def run():
        err = fn(len(raws), *raws[0].args(), *rest, stream)
        assert err == 0, err
    return run, raws


def host_ms(fn, reps=100):
    """Host milliseconds a call of ``fn`` takes to return while a spin
    kernel holds the device, so no call waits for the device."""
    import time

    import torch

    import chip_smoke as cs

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/row_groups.cu to time beside")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import chip_smoke as cs
    from recbole_cdr_tpu_torch.ops import build, row_groups

    if not torch.cuda.is_available():
        sys.exit("probe_row_groups.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    src_path = os.path.join(build.CSRC_DIR, "row_groups.cu")
    texts = variant_texts(open(src_path).read())
    if args.parent:
        texts["parent"] = open(os.path.join(args.parent, "recbole_cdr_tpu_torch", "csrc",
                                            "row_groups.cu")).read()
    fns = build.build_variants("row_groups", "row_groups_plan", texts, "probe_row_groups")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sets_by_shape = shapes(dev, gen)
    for shape, sets in sets_by_shape.items():
        wants = [row_groups.canonical(row_groups.group_rows_plain(i.cpu(), n)) for i, n in sets]
        heads = [int(w[0].numel()) for w in wants]
        most = [int(w[1].max()) if w[1].numel() else 0 for w in wants]
        over = [int((w[1] > 1024).sum()) for w in wants]
        row = {}
        for name, fn in fns.items():
            run, raws = launcher(fn, sets, stream)
            run()
            torch.cuda.synchronize()
            for raw, want in zip(raws, wants if name not in UNCHECKED else ()):
                for a, b in zip(row_groups.canonical(raw.groups), want):
                    assert torch.equal(a, b), f"{name} at {shape} differs from the plain version"
            row[name] = cs.device_ms(run, reps=50)[0]
        print(f"{shape}: ids {[int(i.shape[0]) for i, _ in sets]}, heads {heads}, largest "
              f"head {most}, heads over 1,024 positions {over}; device ms " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)

    # the call's host cost at the catalog step, on the library as built
    ids, rows = sets_by_shape["catalog step"][0]
    plan = row_groups.RowPlan(rows, dev, capacity=ids.shape[0])
    lib = build.library("row_groups")

    def fresh():
        R = ids.shape[0]
        buf = torch.empty(4 + 7 * R, dtype=torch.int32, device=dev)
        groups = row_groups.Groups(R, rows, 0, buf, plan.scratch[1])
        base, cnt = buf.data_ptr(), plan.scratch.data_ptr()
        bufs = (ctypes.c_void_p * 10)(cnt, cnt + 4 * rows,
                                      base, *(base + 16 + 4 * R * k for k in range(7)))
        err = lib.row_groups_plan(1, ids.contiguous().data_ptr(), R, rows, 0,
                                  ctypes.cast(bufs, ctypes.c_void_p), None, 0, 0, 0, None,
                                  build.stream_handle(ids))
        build.check(err, "group_rows")
        return groups

    calls = {"kept plan": lambda: row_groups.group_rows(ids, plan), "fresh buffers": fresh}
    call = {k: cs.call_ms(fn, reps=200, warmup=10) for k, fn in calls.items()}
    host = {k: host_ms(fn) for k, fn in calls.items()}
    print("group_rows per call at the catalog step: " +
          ", ".join(f"{k} {v:.4f} ms (host {host[k]:.4f} ms)" for k, v in call.items()),
          flush=True)


if __name__ == "__main__":
    main()
