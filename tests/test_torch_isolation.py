"""The port imports neither jax nor the JAX package: a source scan of the
package and chip_smoke.py, and a fresh interpreter that imports every module
of the package and runs the entry point, on the dense path, on the sparse
optimizer with the streaming evaluator, for BiTGCF, for NATR with GAUC,
for DCDCSR's and SSCDR's phases (the host batch path included), and for
CLFM, DeepAPF and CoNet."""

import ast
import os
import pkgutil
import subprocess
import sys

import recbole_cdr_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "recbole_cdr_tpu"}


def _sources():
    pkg = os.path.join(REPO, "recbole_cdr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_source_scan_finds_no_jax_import():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_PROBE = """
import importlib, pkgutil, sys
import recbole_cdr_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name != "recbole_cdr_tpu_torch.__main__":
        importlib.import_module(m.name)
for model, extra in (("CMF", {}),
                     ("CMF", {"phase_optimizer": "sparse", "streaming_topk_threshold": 1}),
                     ("BiTGCF", {}),
                     ("NATR", {"train_epochs": ["SOURCE:1", "TARGET:1"],
                               "metrics": ["Recall", "GAUC"]}),
                     ("DCDCSR", {"train_epochs": ["SOURCE:1", "TARGET:1", "BOTH:1",
                                                  "TARGET:1"]}),
                     ("SSCDR", {"train_epochs": ["TARGET:1", "OVERLAP:1"]}),
                     ("CLFM", {}), ("DeepAPF", {}), ("CoNet", {})):
    res = pkg.run_recbole_cdr(model=model, config_dict={
        "state": "ERROR", "device": "cpu", "train_epochs": ["BOTH:1"],
        "train_batch_size": 2048, **extra})
    assert res["test_result"], res
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in {"jax", "jaxlib", "optax", "recbole_cdr_tpu"})
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def test_fresh_interpreter_never_loads_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_every_module_is_scanned():
    mods = {m.name for m in pkgutil.walk_packages(recbole_cdr_tpu_torch.__path__,
                                                  "recbole_cdr_tpu_torch.")}
    assert {"recbole_cdr_tpu_torch.ops.gather_dot", "recbole_cdr_tpu_torch.trainer.device_loop",
            "recbole_cdr_tpu_torch.evaluator.evaluator", "recbole_cdr_tpu_torch.ops.topk",
            "recbole_cdr_tpu_torch.ops.sparse_adam", "recbole_cdr_tpu_torch.ops.graph_layer",
            "recbole_cdr_tpu_torch.models.bitgcf", "recbole_cdr_tpu_torch.models.natr",
            "recbole_cdr_tpu_torch.ops.natr_attention", "recbole_cdr_tpu_torch.ops.rank_sum",
            "recbole_cdr_tpu_torch.ops.benchmark_topk", "recbole_cdr_tpu_torch.models.dcdcsr",
            "recbole_cdr_tpu_torch.models.emcdr", "recbole_cdr_tpu_torch.models.sscdr",
            "recbole_cdr_tpu_torch.models.clfm", "recbole_cdr_tpu_torch.models.deepapf",
            "recbole_cdr_tpu_torch.models.conet", "recbole_cdr_tpu_torch.ops.deepapf_attention",
            "recbole_cdr_tpu_torch.ops.conet_tower"} <= mods
    assert len(list(_sources())) == len(mods) + 2  # + package __init__ + chip_smoke.py
