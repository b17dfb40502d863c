#!/usr/bin/env python3
"""Whether a training run on the card repeats bit for bit.

Runs each configuration below twice with the same seed through
``run_recbole_cdr`` on the card and prints, per model, how many trained
parameters are ``torch.equal`` between the two runs, the largest difference
of the others, and whether every epoch's loss and every test metric agree:

- CMF on ``chip_smoke.py``'s dense pair (phase 3's configuration): K1's
  backward, which adds each row's gradients in position order;
- DTCDR NeuMF (phase 7a's configuration, BOTH:2): torch's index backward
  behind the embedding gathers;
- DTCDR DMF (phase 7d's, labeled): B11, whose sums run in a fixed order;
- CLFM, DeepAPF and CoNet (phase 11's configurations, BOTH:2): torch's
  index backward behind their embedding gathers.

Run from the repository root on a machine with one NVIDIA GPU; names after
the script keep only the runs whose name starts with one of them:

    python3 probe_repeatability.py [CLFM DeepAPF ...]
"""

import subprocess
import sys
import time


def runs():
    import chip_smoke as cs

    return (("CMF", "CMF", cs.config_dict()),
            ("DTCDR NeuMF", "DTCDR", cs.dtcdr_config("NeuMF", "full", 2)),
            ("DTCDR DMF labeled", "DTCDR", cs.dtcdr_config("DMF", "labeled", 2)),
            *((model, model, cs.phase11_config(model)) for model in ("CLFM", "DeepAPF", "CoNet")))


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from recbole_cdr_tpu_torch import run_recbole_cdr

    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs.gen_data()
    only = sys.argv[1:]
    for name, model, cfg in runs():
        if only and not any(name.startswith(o) for o in only):
            continue
        results = []
        for _ in range(2):
            t0 = time.perf_counter()
            results.append(run_recbole_cdr(model=model, config_dict=cfg, saved=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        a, b = (r["model"].state_dict() for r in results)
        differ = {k: float((a[k].float() - b[k].float()).abs().max()) for k in a
                  if not torch.equal(a[k], b[k])}
        losses = [[h["loss"] for h in r["history"]] for r in results]
        print(f"{name}: {len(a) - len(differ)} of {len(a)} parameters bit-equal"
              + (f", the others differ by at most {max(differ.values()):.3g} ({sorted(differ)})"
                 if differ else "")
              + f"; losses equal {losses[0] == losses[1]}; test metrics equal "
              f"{results[0]['test_result'] == results[1]['test_result']}; "
              f"{wall:.1f} s a run", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
