#!/usr/bin/env python3
"""Where B16's grid kernel (DeepAPF's predict fallback) spends its time.

Times the grid of ``recbole_cdr_tpu_torch/csrc/deepapf_attention.cu`` on a
fallback tile, [32 users x 4,980 items] at D 64 with the items the entity
(the shape ``chip_smoke.py`` times in its phase 2), in float32 and in
bfloat16 (tables scaled by ``chip_smoke.GRID16_SCALE``), beside two variants
of the source built for this probe: the staging and products alone (the
epilogue replaced by a sum of every accumulator) and the staging alone (the
products replaced by the bias too). Prints one line a type. Run from the
repository root on a machine with one NVIDIA GPU:

    python3 probe_deepapf_grid.py
"""

import os
import sys

#: where the variants cut the kernel: the epilogue's start and its end, and
#: the products' call
MARKS = (
    "#pragma unroll\n      for (int s = 0; s < MT; ++s) {\n        // a = relu(z)",
    "    __syncthreads();  // the rows are restaged next",
    "      grid_products<D, T, MT>(E, O, Tt, wf, bs, pls, acc, se, so);\n",
)
#: every accumulator summed and written where the epilogue was
SUM_ALL = (
    "      float lg = 0.f;\n#pragma unroll\n      for (int s = 0; s < MT; ++s)\n"
    "#pragma unroll\n        for (int j = 0; j < G::NT; ++j)\n"
    "          lg += acc[s][j][0] + acc[s][j][1] + acc[s][j][2] + acc[s][j][3] + se[s] + so[s];\n"
    "      if (c == 0 && i0 + s0 + g < I)\n"
    "        st1(out + (long long)(u0 + u) * I + i0 + s0 + g, lg + (float)ent[0]);\n    }\n")
#: the bias where the products were
NO_PRODUCTS = (
    "#pragma unroll\n      for (int s = 0; s < MT; ++s) {\n        se[s] = so[s] = (float)E[s][0];\n"
    "#pragma unroll\n        for (int j = 0; j < G::NT; ++j)\n"
    "          acc[s][j][0] = acc[s][j][1] = acc[s][j][2] = acc[s][j][3] = bs[j];\n      }\n")
B, I, D, ROWS, OVERLAPPED = 32, 4980, 64, 6000, 2000


def variants(build):
    """{name: the variant's ``deepapf_grid`` entry}, both built at once."""
    src = open(os.path.join(build.CSRC_DIR, "deepapf_attention.cu")).read()
    epi, end, call = MARKS
    if not all(m in src for m in MARKS):
        sys.exit("the kernel source no longer holds the probe's marks")
    products = src[:src.index(epi)] + SUM_ALL + src[src.index(end):]
    texts = {"products": products, "staging": products.replace(call, NO_PRODUCTS)}
    return build.build_variants("deepapf_attention", "deepapf_grid", texts, "grid_probe")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from chip_smoke import GRID16_SCALE, device_ms
    from recbole_cdr_tpu_torch.ops import build

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device="cuda", generator=g)
    share_t, only_t, other_t = (rnd(ROWS, D, scale=0.3) for _ in range(3))
    w = (rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1), rnd(D, 1, scale=0.3), rnd(D, 1, scale=0.3))
    users = torch.randint(0, ROWS, (B,), device="cuda", generator=g, dtype=torch.int32)
    items = torch.arange(I, device="cuda", dtype=torch.int32)
    fns = {"kernel": build.library("deepapf_attention").deepapf_grid, **variants(build)}
    for dt in (torch.float32, torch.bfloat16):
        scale = 1.0 if dt == torch.float32 else GRID16_SCALE
        tabs = [(scale * t).to(dt) for t in (share_t, only_t, other_t)]
        ws = [t.to(dt).contiguous() for t in w]
        out = torch.empty(B, I, dtype=dt, device="cuda")
        times = {}
        for name, fn in fns.items():
            def launch(fn=fn, name=name):
                build.check(fn(*(x.data_ptr() for x in (*tabs, users, items)), B, I, OVERLAPPED,
                               1, *(x.data_ptr() for x in ws), D, out.data_ptr(),
                               build.DTYPES[dt], build.stream_handle(users)), name)
            times[name] = device_ms(launch, 20)[0]
        print(f"deepapf_grid probe [{dt}, {B} x {I}, D {D}]: kernel {times['kernel']:.4f} ms, "
              f"staging and products alone {times['products']:.4f} ms, staging alone "
              f"{times['staging']:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
