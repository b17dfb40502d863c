#!/usr/bin/env python3
"""B2 and B2a (``csrc/neg_sampler.cu``) beside variants of their source, at
``chip_smoke.py``'s shapes.

Calls, each on a source stream's history rows and live lengths
(``DomainDeviceData``) with every interaction's user once, in a random
order: B2 on the dense pair's (phase 2 draws one epoch's 77,824 of its
220,557 slots), B2a on the same stream under popularity sampling (phase
9b's) and on the catalog pair's (phase 2's B2a call). Each variant's
negatives are held equal to the kernel's, and the device time is the mean
of calls queued behind a spin kernel (``chip_smoke.py::device_ms``).
Variants, each the source with lines replaced: the rounds drawn and
compared at once (the round loop replaced by ``BATCHED``: 1, 2, 4 or 16
rounds, 16 the earlier design's every round at once, 1 the kernel's own
loop written with a one-round mask), the warp's collisions as a bool ORed
by ``__any_sync`` (``warp_vote``) and the longest history a slot walks
alone (``kLaneWalk`` 8 or 128). Run from the
repository root on a machine with one NVIDIA GPU:

    python3 probe_neg_sampler.py
"""

import os
import sys

#: the kernel's round loop, from its first line to the line after it
LOOP = ("  for (int r = 0; r < kRounds; ++r) {\n", "  if (live) out[t] = neg;")
#: a round loop that draws KBATCH rounds at once, walks the live row once a
#: batch and folds each entry into a KBATCH-bit collision mask; the first
#: batch with a clean round picks its first clean round
BATCHED = """\
  auto collide = [](int v, const int (&cand)[KBATCH]) {
    uint32_t hit = 0;
#pragma unroll
    for (int r = 0; r < KBATCH; ++r) hit |= (uint32_t)(v == cand[r]) << r;
    return hit;
  };
  for (int r0 = 0; r0 < kRounds; r0 += KBATCH) {
    int cand[KBATCH] = {};
    uint32_t coll = 0;
    if (!done) {
#pragma unroll
      for (int k = 0; k < KBATCH; ++k) {
        const uint32_t r = (uint32_t)(r0 + k);
        const int rank = (int)(fmix32(b + r * 0x9E3779B9u) % n_cand);
        if (kAlias) {
          const uint32_t y = fmix32(b2 + r * 0x9E3779B9u);
          const float u01 = (float)(y >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
          const int ali = __ldg(al.alias + rank);
          const bool take = u01 < __ldg(al.prob + rank) || ali < 0;
          cand[k] = __ldg(al.values + (take ? rank : ali));
        } else {
          cand[k] = rank < l0 ? s0 + rank : s1 + (rank - l0);
        }
      }
      if (len <= kLaneWalk) {
        int h = 0;
        if (vec) {
          const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
          for (; h + 4 <= len; h += 4) {
            const int4 q = __ldg(row4 + (h >> 2));
            coll |= collide(q.x, cand) | collide(q.y, cand) | collide(q.z, cand) |
                    collide(q.w, cand);
          }
        }
        for (; h < len; ++h) coll |= collide(__ldg(row + h), cand);
      }
    }
    for (unsigned wide = __ballot_sync(kAll, !done && len > kLaneWalk); wide;
         wide &= wide - 1) {
      const int owner = __ffs(wide) - 1;
      const int n = __shfl_sync(kAll, len, owner);
      const int* r = hist + (long long)__shfl_sync(kAll, user, owner) * H;
      int c[KBATCH];
#pragma unroll
      for (int k = 0; k < KBATCH; ++k) c[k] = __shfl_sync(kAll, cand[k], owner);
      uint32_t m = 0;
      for (int h = lane; h < n; h += 32) m |= collide(__ldg(r + h), c);
      m = __reduce_or_sync(kAll, m);
      if (lane == owner) coll = m;
    }
    const uint32_t clean = ~coll & ((1u << KBATCH) - 1u);
    if (!done && (clean || r0 + KBATCH == kRounds)) {
      const int pick = clean ? __ffs(clean) - 1 : KBATCH - 1;
      neg = cand[KBATCH - 1];
#pragma unroll
      for (int k = KBATCH - 2; k >= 0; --k)
        if (k == pick) neg = cand[k];
      done = true;
    }
    if (!__any_sync(kAll, !done)) break;
  }
"""
LANE_WALK = "constexpr int kLaneWalk = 32;"


def batched(src, k):
    """``src`` with its round loop replaced by ``BATCHED`` at ``k`` rounds."""
    i, j = src.index(LOOP[0]), src.index(LOOP[1])
    assert src.count(LOOP[0]) == src.count(LOOP[1]) == 1, LOOP
    return src[:i] + BATCHED.replace("KBATCH", str(k)) + src[j:]


WARP_OR = (("      unsigned m = 0;", "      bool m = false;"),
           ("      m = __reduce_or_sync(kAll, m);", "      m = __any_sync(kAll, m);"))


def warp_vote(src):
    """``src`` with the warp's collisions held in a bool and ORed by a vote."""
    for old, new in WARP_OR:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


VARIANTS = {
    "batch1": lambda src: batched(src, 1),
    "batch2": lambda src: batched(src, 2),
    "batch4": lambda src: batched(src, 4),
    "batch16": lambda src: batched(src, 16),
    "warp_vote": warp_vote,
    "lane_walk8": lambda src: src.replace(LANE_WALK, "constexpr int kLaneWalk = 8;"),
    "lane_walk128": lambda src: src.replace(LANE_WALK, "constexpr int kLaneWalk = 128;"),
}


def stream(cs, cfg, dev, gen):
    """(uids in a random order, the stream's DomainDeviceData) of the source
    stream of ``cfg``'s pair."""
    import torch

    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.utils import create_dataset, data_preparation
    from recbole_cdr_tpu_torch.trainer.device_loop import DomainDeviceData
    from recbole_cdr_tpu_torch.utils import init_seed

    config = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = create_dataset(config)
    train, _, _ = data_preparation(config, dataset)
    b = train.source_batcher
    data = DomainDeviceData(b.table, b.sampler, dataset.num_total_user, dev)
    return data.uid[torch.randperm(data.n, device=dev, generator=gen)], data


def main():
    import ctypes
    from types import SimpleNamespace

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from recbole_cdr_tpu_torch.ops import build
    from recbole_cdr_tpu_torch.ops import neg_sampler as k2

    if not torch.cuda.is_available():
        sys.exit("probe_neg_sampler.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    cs.gen_data()
    cs.gen_catalog()
    build.build_all()
    src = open(os.path.join(build.CSRC_DIR, "neg_sampler.cu")).read()
    assert src.count(LANE_WALK) == 1, LANE_WALK
    texts = {name: cut(src) for name, cut in VARIANTS.items()}
    fns = build.build_variants("neg_sampler", "neg_sampler", texts, "probe_neg_sampler")
    libs = {"kernel": build.library("neg_sampler")}
    for name, fn in fns.items():
        pop = ctypes.CDLL(os.path.join(build.build_dir(), "probe_neg_sampler", name + ".so"))
        p = pop.neg_sampler_popularity
        p.argtypes = build._SIGNATURES["neg_sampler"]["neg_sampler_popularity"]
        p.restype = ctypes.c_int
        libs[name] = SimpleNamespace(neg_sampler=fn, neg_sampler_popularity=p)
    bits = lambda n: torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,  # noqa: E731
                                   device=dev, generator=gen)
    uid, data = stream(cs, cs.config_dict(), dev, gen)
    base = bits(uid.shape[0])
    calls = {"B2, the dense source stream": lambda: k2.sample_negatives(
        base, uid, data.hist, data.cand_ranges, 1, data.lens)}
    for what, cfg in (("B2a, the dense source stream (9b)", cs.popularity_cmf_config()),
                      ("B2a, the catalog source stream", cs.catalog_config())):
        if "catalog" in what:
            cfg = {**cfg, "neg_sampling": {"popularity": 1}}
        u, d = stream(cs, cfg, dev, gen)
        b, a = bits(u.shape[0]), bits(u.shape[0])
        calls[what] = (lambda u=u, d=d, b=b, a=a:
                       k2.sample_negatives_popularity(b, a, u, d.hist, d.alias, 1, d.lens))
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    for what, fn in calls.items():
        want = fn()
        row = {}
        try:
            for name, lib in libs.items():
                build._libs["neg_sampler"] = lib
                assert torch.equal(fn(), want), f"{name} differs from the kernel at {what}"
                row[name] = cs.device_ms(fn, reps=20)[0]
        finally:
            build._libs["neg_sampler"] = libs["kernel"]
        print(f"{what}: {want.shape[0]} slots; device ms " +
              ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
