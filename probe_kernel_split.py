#!/usr/bin/env python3
"""Where B11 (DTCDR DMF's rating-vector product) and B15 (CoNet's full-sort
tower) spend their device time.

At ``chip_smoke.py`` phase 2's shapes: B11 on a DMF training step's source
item side (16,384 ids of the dense pair's step, every id's history of
source users) and B15 on the dense evaluator's tile ([2,048 users x 4,980
items], the published tower 64 -> 32 -> 16 -> 8 -> 1), each in float32 and
bfloat16. Prints, per call, the device time of every CUDA kernel the call
launches (``torch.profiler``), then B15's kernel beside variants of its
source built for this probe: the published tower's products skipped (the
item rows' staging, the first layer and the output layer alone), its
widths through the run-time-width path, and two users a float32 step
(one is the kernel's). Each variant's
probabilities are held against the kernel's (the largest difference is
printed).
Run from the repository root on a machine with one NVIDIA GPU:

    python3 probe_kernel_split.py
"""

import os
import sys

#: the probe's cuts of csrc/conet_tower.cu: (what, replaced by) per variant
VARIANTS = {
    # the published tower's products skipped
    "no_products": (("wg_products<T, M, S>(x, a, wsm, fl);", ""),),
    # the published tower through the run-time-width path
    "runtime_widths": (("bool published = tw.n == Published::kN;", "bool published = false;"),),
    # two users a float32 step
    "m2_float32": (("constexpr int M = F32 || !kFixed ? 1 : 2;",
                    "constexpr int M = !kFixed ? 1 : 2;"),),
}
B, I = 2048, 4980
TOWER = [64, 32, 16, 8]


def show(what, split):
    print(f"{what}: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                                                     key=lambda kv: -kv[1]))
          + f" (ms a call; {sum(split.values()):.4f} in all)", flush=True)


def b11_operands(dev):
    """(csr, table, ids, gout, N) of a DMF step's source item side."""
    import torch

    import chip_smoke as cs
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
    from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
    from recbole_cdr_tpu_torch.utils import init_seed
    from recbole_cdr_tpu_torch.utils.enums import TrainMode

    _, base, mode, _ = cs.DTCDR_RUNS[2]
    config = CDRConfig(model="DTCDR", config_dict=cs.dtcdr_config(base, mode, 1), _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    model = DTCDR(config, dataset).to(dev)
    loop = DeviceEpochLoop(TrainMode.BOTH, None, train_data, config["MODEL_INPUT_TYPE"], 1,
                           dataset.num_total_user, TorchRandomSource(3, dev), dev)
    xs = loop._build_xs(loop._shuffle_material(0), 0, 0, 1)
    items = torch.cat([xs["source_item_id"][0], xs["target_item_id"][0]]).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(0)
    N, D = model.source_item_linear.shape
    x = 0.3 * torch.randn(N, D, device=dev, generator=g)
    gout = torch.randn(items.shape[0], D, device=dev, generator=g)
    return model._csr("s_users"), x, items, gout, N


def b15_variants(build):
    """{name: the variant's ``conet_tower`` entry}, built at once."""
    src = open(os.path.join(build.CSRC_DIR, "conet_tower.cu")).read()
    texts = {}
    for name, cuts in VARIANTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                sys.exit(f"the tower source no longer holds the probe's mark {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return build.build_variants("conet_tower", "conet_tower", texts, "tower_probe")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from recbole_cdr_tpu_torch.ops import build
    from recbole_cdr_tpu_torch.ops import conet_tower as b15
    from recbole_cdr_tpu_torch.ops import rating_vector as b11

    kernel_split = cs.kernel_split
    dev = torch.device("cuda")
    cs.gen_data()
    csr, x, ids, gout, N = b11_operands(dev)
    R = csr.ptr.shape[0] - 1
    show("rating_vector_plan", kernel_split(lambda: b11.rating_vector_plan(ids, R)))
    plan = b11.rating_vector_plan(ids, R)
    for table in (x, x.to(torch.bfloat16)):
        show(f"rating_vector_forward [{table.dtype}]",
             kernel_split(lambda: b11.rating_vector_forward(csr, table, ids, plan)))
        show(f"rating_vector_backward [{table.dtype}]",
             kernel_split(lambda: b11.rating_vector_backward(csr, N, ids, gout, table.dtype, plan)))

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, scale: scale * torch.randn(*shape, device=dev, generator=g)  # noqa: E731
    H0 = TOWER[0]
    layers = [(rnd(a, b, scale=(2 / (a + b)) ** 0.5), rnd(b, scale=0.1))
              for a, b in zip(TOWER, TOWER[1:])]
    out = (rnd(TOWER[-1], 1, scale=0.5), rnd(1, scale=0.1))
    args32 = (rnd(B, H0, scale=0.5), rnd(I, H0, scale=0.5), rnd(H0, scale=0.1), layers, out)
    fns = {"kernel": build.library("conet_tower").conet_tower, **b15_variants(build)}
    for dt in (torch.float32, torch.bfloat16):
        hu, hi, b0, lay, o = b15.padded_tower(
            *(t.to(dt) for t in args32[:3]), [(W.to(dt), b.to(dt)) for W, b in args32[3]],
            tuple(t.to(dt) for t in args32[4]))
        show(f"conet_tower [{dt}]", kernel_split(lambda: b15.conet_tower(hu, hi, b0, lay, o)))
        weights = b15.packed_weights(lay, o)
        widths = [H0] + [W.shape[1] for W, _ in lay]
        res = torch.empty(B, I, dtype=dt, device=dev)
        ref = b15.conet_tower(hu, hi, b0, lay, o)
        times, diffs = {}, {}
        for name, fn in fns.items():
            def launch(fn=fn, name=name):
                build.check(fn(hu.data_ptr(), hi.data_ptr(), b0.data_ptr(), B, I,
                               weights.data_ptr(), len(lay), *widths,
                               *([0] * (b15.MAX_LAYERS + 1 - len(widths))), res.data_ptr(),
                               build.DTYPES[dt], build.stream_handle(hu)), name)
            times[name] = cs.device_ms(launch, 10)[0]
            diffs[name] = float((res.float() - ref.float()).abs().max())
        print(f"conet_tower probe [{dt}, {B} x {I}]: " + ", ".join(
            f"{k} {v:.4f} ms (max |p - kernel's| {diffs[k]:.3g})" for k, v in times.items()),
            flush=True)
    for line in build.build_logs.get("conet_tower", "").splitlines():
        if "wgmma" in line:
            print(f"ptxas conet_tower.cu: {line.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
