#!/usr/bin/env python3
"""CLFM's and CoNet's training gathers on the card: ``F.embedding`` (what
the models call) against the index gather (``table[ids]``).

Both models gather their embedding rows per step and take the gathers'
backward; ``F.embedding``'s backward adds a row's gradient rows in an order
the ids fix. For each model, one warm BOTH epoch and one validation pass at
``chip_smoke.py`` phase 11's configuration, profiled as ``chip_smoke.py
--profile`` profiles them (``profile_epoch``): device busy and the
unprofiled wall. The gathers alternate F.embedding, index, index,
F.embedding in one process, so that a drift of the host's speed within the
process shows; the index form replaces every ``F.embedding`` call of the
process by ``table[ids]`` (the models make no other). Run from the
repository root on a machine with one NVIDIA GPU:

    python3 probe_gather.py
"""

import os
import sys

MODELS = ("CLFM", "CoNet")
ORDER = ("embedding", "index", "index", "embedding")


def index_gather(ids, table, *args, **kwargs):
    """``F.embedding``'s function by indexing: rows ``ids`` of ``table``."""
    return table[ids.long()]


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("probe_gather.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    cs.gen_data()
    embedding = torch.nn.functional.embedding
    for model in MODELS:
        for k, form in enumerate(ORDER):
            torch.nn.functional.embedding = embedding if form == "embedding" else index_gather
            try:
                cs.profile_epoch(dev, cs.phase11_config(model), f"{model} {form} #{k}: ",
                                 export=False, model=model)
            finally:
                torch.nn.functional.embedding = embedding


if __name__ == "__main__":
    main()
