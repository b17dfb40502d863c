#!/usr/bin/env python3
"""Where B8 (BiTGCF's graph layer, ``csrc/graph_layer.cu``) spends its
device time, at ``chip_smoke.py`` phase 2's shapes.

Builds phase 2's own operands: the source graph of the dense pair
(``chip_smoke.py::bitgcf_graph``: BiTGCF's normalised adjacency and its
transpose, each as the CSR with the kernel's schedule, ``csr_from_scipy``),
``x`` [N, 64] (0.1 * normal), an upstream gradient ``g`` (normal) and
dropout bits at keep 0.7. Prints the schedule's shape (rows, nonzeros, the
degree quantiles, the longest row, each schedule array's length), then for
float32 and bfloat16 the forward and the backward: the device time of each
kernel a call launches (a ``torch.profiler`` trace: the product, the
heavy-row pass, the backward's prep, whatever the source launches) and of
the whole call (calls queued behind a spin kernel,
``chip_smoke.py::device_ms``), each call first held against its plain
version within phase 2's tolerances and against a second run bit for bit.

With ``--parent DIR`` (a checkout of an earlier design, for example a
``git archive`` of the parent commit unpacked under ``build/``), the probe
runs in four child processes, DIR, this checkout, this checkout, DIR, each
importing its own checkout's package, ``chip_smoke.py`` and build
directory, so that both designs are timed on one card in turns.
Run from the repository root on a machine with one NVIDIA GPU:

    python3 probe_graph_layer.py [--parent DIR]
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
D = 64


def operands(cs, dev):
    """(csr, csr_t, x, g, bits, keep) at phase 2's source graph."""
    import torch

    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset
    from recbole_cdr_tpu_torch.ops import graph_layer as b8
    from recbole_cdr_tpu_torch.utils import init_seed

    cs.gen_data()
    config = CDRConfig(model="CMF", config_dict=cs.config_dict(), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    graph = cs.bitgcf_graph(dataset)
    csr, csr_t = (b8.CSR(*(t.to(dev) for t in b8.csr_from_scipy(m))) for m in graph)
    N = csr.row_ptr.shape[0] - 1
    g = torch.Generator(device=dev).manual_seed(0)
    x = 0.1 * torch.randn(N, D, device=dev, generator=g)
    gy = torch.randn(N, D, device=dev, generator=g)
    bits = torch.randint(-2 ** 31, 2 ** 31, (N, D), dtype=torch.int32, device=dev, generator=g)
    return csr, csr_t, x, gy, bits, 1.0 - cs.B8_DROP, graph


def variant_module(b8, cuts):
    """A copy of ``ops/graph_layer.py`` with ``cuts`` ((line, replacement)
    pairs) made in its text: its schedule and its calls, on the library that
    ``build`` holds."""
    import types

    text = open(b8.__file__).read()
    for old, new in cuts:
        if text.count(old) != 1:
            sys.exit(f"ops/graph_layer.py no longer holds the probe's mark {old!r} once")
        text = text.replace(old, new)
    mod = types.ModuleType(b8.__name__ + "_variant")
    exec(compile(text, b8.__file__, "exec"), mod.__dict__)
    return mod


def schedule_shape(b8, csr):
    """One line: rows, nonzeros, degree quantiles, the longest row and its
    pieces, each schedule array's length."""
    import torch

    deg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).double()
    q = torch.quantile(deg, torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64,
                                         device=deg.device)).tolist()
    piece = getattr(b8, "PIECE", 0)
    longest = int(deg.max())
    arrays = {f: tuple(getattr(csr, f).shape) for f in csr._fields
              if f not in ("row_ptr", "col", "val")}
    return (f"rows {deg.shape[0]}, nonzeros {csr.col.shape[0]}, mean degree "
            f"{float(deg.mean()):.2f}, quantiles 50/90/99/99.9% "
            f"{', '.join(f'{v:g}' for v in q)}, longest row {longest} nonzeros "
            f"({-(-longest // piece) if piece else '-'} pieces of {piece}), rows over one piece "
            f"{int((deg > piece).sum()) if piece else '-'}; schedule arrays {arrays}")


def kernel_name(mangled):
    """``name<template arguments>`` of a mangled kernel of ``graph_layer.cu``
    (1 / 0 for true / false)."""
    import re

    m = re.search(r"\d+([A-Za-z_]+_kernel)I(.*?)EEv", mangled)
    if not m:
        return mangled[-48:]
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    args = [names.get(a, a[2:-1]) for a in re.findall(r"L[ib]\d+E|13__nv_bfloat16|6__half|f",
                                                       m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_summary(log):
    """One line from nvcc's ``-Xptxas -v`` report of ``graph_layer.cu``: each
    kernel's registers (and spill stores / loads in bytes where it spills)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and (int(m.group(1)) or int(m.group(2))):
            out[name] = f"spills {m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} regs" + (f" {out[name]}" if name in out else "")
    return "; ".join(f"{k} {v}" for k, v in sorted(out.items()))


#: variants timed beside the kernel: (cuts of csrc/graph_layer.cu, cuts of
#: ops/graph_layer.py), each as (line, replacement) pairs; a variant with
#: the kernel's schedule sums in the kernel's order and must equal it bit for
#: bit, one with another schedule sums in another order and is held to the
#: probe's tolerance
KROUND = "constexpr int kRound = 4;"
KPIECES = "constexpr int kPieces = 16;"
KCOLUMNS = "constexpr int kLaneColumns = 8;"
HEAVY_FIRST = "    rows = torch.cat([rows[pieces > 1], rows[pieces == 1]])"
VARIANTS = {
    # the pieces in row order
    "row_order": ((), ((HEAVY_FIRST, "    pass"),)),
    # pieces of at most 64 or 16 nonzeros
    "piece64": ((), (("PIECE = 32\n", "PIECE = 64\n"),)),
    "piece16": ((), (("PIECE = 32\n", "PIECE = 16\n"),)),
    # eight or two rows in flight a lane
    "round8": (((KROUND, "constexpr int kRound = 8;"),), ()),
    "round2": (((KROUND, "constexpr int kRound = 2;"),), ()),
    # 16 columns of a row a lane
    "columns16": (((KCOLUMNS, "constexpr int kLaneColumns = 16;"),), ()),
    # 8 pieces a block
    "pieces8": (((KPIECES, "constexpr int kPieces = 8;"),),
                (("PIECES_PER_BLOCK = 16\n", "PIECES_PER_BLOCK = 8\n"),)),
    # every block waits at the barriers
    "always_sync": ((("    if (!several) continue;\n", ""),), ()),
}


def variant_libraries(build):
    """{name: an object with the variant's two entries}, built at once."""
    import ctypes
    from types import SimpleNamespace

    src = open(os.path.join(build.CSRC_DIR, "graph_layer.cu")).read()
    texts = {}
    for name, (cuts, _) in VARIANTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f"graph_layer.cu no longer holds the probe's mark {old!r} once")
            text = text.replace(old, new)
        texts[name] = text
    try:
        fwd = build.build_variants("graph_layer", "graph_layer_forward", texts,
                                   "probe_graph_layer")
    except RuntimeError as e:  # nvcc's whole report would bury the error
        sys.exit(str(e)[:3000])
    libs = {}
    for name, f in fwd.items():
        lib = ctypes.CDLL(os.path.join(build.build_dir(), "probe_graph_layer", name + ".so"))
        b = lib.graph_layer_backward
        b.argtypes = build._SIGNATURES["graph_layer"]["graph_layer_backward"]
        b.restype = ctypes.c_int
        libs[name] = SimpleNamespace(graph_layer_forward=f, graph_layer_backward=b)
    return libs


def worker(root, variants):
    """Time this process's checkout (``root``) and print its lines; with
    ``variants``, the cuts of its source too."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from recbole_cdr_tpu_torch.ops import graph_layer as b8

    if not torch.cuda.is_available():
        sys.exit("probe_graph_layer.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    tag = os.path.basename(os.path.normpath(root))
    csr, csr_t, x, gy, bits, keep, graph = operands(cs, dev)
    from recbole_cdr_tpu_torch.ops import build

    build.build_all()
    libs = variant_libraries(build) if variants else {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{tag}] card: {smi}", flush=True)
    if build.build_logs.get("graph_layer"):
        print(f"[{tag}] ptxas graph_layer.cu: {ptxas_summary(build.build_logs['graph_layer'])}",
              flush=True)
    print(f"[{tag}] graph {schedule_shape(b8, csr)}", flush=True)
    print(f"[{tag}] transpose {schedule_shape(b8, csr_t)}", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        c, ct = (m._replace(val=m.val.to(dt)) for m in (csr, csr_t))
        xd, gd = x.to(dt), gy.to(dt)
        new, side = b8.graph_layer_forward(c, xd, bits, keep)
        p_new, p_side = b8.graph_layer_forward_plain(c, xd, bits, keep)
        gx = b8.graph_layer_backward(ct, xd, side, bits, keep, gd)
        p_gx = b8.graph_layer_backward_plain(ct, xd, side, bits, keep, gd)
        torch.cuda.synchronize()
        err = [float((a.float() - b.float()).abs().max()) for a, b in
               ((new, p_new), (side, p_side), (gx, p_gx))]
        scale = [float(b.float().abs().max()) for b in (p_new, p_side, p_gx)]
        rel = max(e / s for e, s in zip(err, scale))
        limit = 1e-5 if dt == torch.float32 else 2 * 2 ** -8
        assert rel <= 2 * limit, f"{dt}: error {err} of scales {scale}"
        new2, side2 = b8.graph_layer_forward(c, xd, bits, keep)
        assert torch.equal(new, new2) and torch.equal(side, side2), f"{dt}: forward differs"
        assert torch.equal(gx, b8.graph_layer_backward(ct, xd, side, bits, keep, gd)), \
            f"{dt}: backward differs"
        calls = {"forward": lambda: b8.graph_layer_forward(c, xd, bits, keep),
                 "backward": lambda: b8.graph_layer_backward(ct, xd, side, bits, keep, gd)}
        for what, fn in calls.items():
            split = cs.kernel_split(fn, reps=20)
            total = cs.device_ms(fn, reps=50)[0]
            print(f"[{tag}] {dt} {what}: {total:.4f} ms a call (queued); by kernel "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                                               key=lambda kv: -kv[1]))
                  + f" (trace sum {sum(split.values()):.4f}); max |kernel - plain| / scale "
                  f"{rel:.3g}, reruns bit-equal", flush=True)
        if not variants:
            continue
        kernel_lib, times = build.library("graph_layer"), {}
        try:
            for name, lib in libs.items():
                build._libs["graph_layer"] = lib
                py_cuts = VARIANTS[name][1]
                mod = variant_module(b8, py_cuts) if py_cuts else b8
                cv, ctv = ((mod.CSR(*(t.to(dev) for t in mod.csr_from_scipy(m)))
                            ._replace(val=o.val) for m, o in zip(graph, (c, ct)))
                           if py_cuts else (c, ct))
                got = (mod.graph_layer_forward(cv, xd, bits, keep)[0],
                       mod.graph_layer_backward(ctv, xd, side, bits, keep, gd))
                diff = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                           for a, b in zip(got, (new, gx)))
                assert diff <= 2 * limit and (py_cuts or diff == 0), (name, diff)
                fns = (lambda: mod.graph_layer_forward(cv, xd, bits, keep),
                       lambda: mod.graph_layer_backward(ctv, xd, side, bits, keep, gd))
                times[name] = [cs.device_ms(fn, reps=50)[0] for fn in fns] + [diff]
        finally:
            build._libs["graph_layer"] = kernel_lib
        print(f"[{tag}] {dt} variants, forward / backward ms (largest difference from the "
              "kernel over its scale): " + "; ".join(
                  f"{k} {f:.4f} / {b:.4f} ({d:.2g})" for k, (f, b, d) in times.items()),
              flush=True)


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
