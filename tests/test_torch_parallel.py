"""The port's mesh (``recbole_cdr_tpu_torch/parallel``) on the CPU: four
processes joined by a gloo process group on ``tcp://127.0.0.1:<free port>``,
as ``tests/test_multihost.py`` spawns its workers, each spawn under its own
timeout so that a deadlock fails the test instead of eating the suite's
clock.

1. One sharded Adam step at data 2 x model 2 against JAX's single-device step
   on the toy of ``tests/test_sharding.py`` (512 x 16 and 384 x 16 tables,
   batch 64): loss within rtol 1e-5, the parameters gathered by
   ``fetch_replicated`` within rtol 1e-4 / atol 1e-5, each rank holding only
   its row shard.
2. B14's plain version (the CPU side of ``sharded_streaming_topk``, through
   the evaluator's tile split) at JAX's awkward sizes (B 37, D 16, I 10,007,
   k 10, H 23) on meshes 4 x 1, 2 x 2 and 1 x 4, and in one process (the m
   shards merged locally), against JAX's ``streaming_topk_with_history``: ids
   exactly equal, scores within rtol 1e-6.
3. One device-loop epoch of CMF on the bundled pair at 2 x 2 against the
   port's single-process epoch, without and with a gradient clip: loss
   within rtol 1e-4, parameters within rtol 1e-3 / atol 1e-5.
4. ``run_recbole_cdr`` for CMF at 2 x 2 with streaming forced, on the device
   loop (joined through the explicit ``distributed`` dict) and on the host
   batch path (``distributed: auto``, torchrun's environment variables),
   and with the dense evaluation (the tables gathered over ``model``):
   every rank returns the same test metrics, each within 0.02 of the
   single-process run.
5. What raises under ``mesh_shape``: a model other than CMF, the sparse
   optimizer, a 16-bit ``compute_dtype`` (NotImplementedError), and a mesh
   that does not match the world (ValueError).
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recbole_cdr_tpu.ops.topk import streaming_topk_with_history

from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.ops.topk import sharded_streaming_topk_plain
from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import TrainMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a spawn of the four workers may take, all of them together
SPAWN_TIMEOUT = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, out_dir, *args):
    """Run ``script`` in ``WORLD`` processes (argv: out_dir, rank, *args),
    one CPU thread each; fail on a timeout or a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(out_dir), str(rank),
                               *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=out_dir)
             for rank in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(WORLD)]


# ---- the toy step, B14 and the epoch: one spawn --------------------------------------

#: the cases' shapes and data, defined once for this module and the workers
_SHARED = r"""
import numpy as np

WORLD = 4
N_USERS, N_ITEMS, TOY_D, TOY_B = 512, 384, 16, 64
TOPK_B, TOPK_D, TOPK_I, TOPK_K, TOPK_H = 37, 16, 10007, 10, 23
MESHES = {"d4m1": {"data": 4, "model": 1}, "d2m2": {"data": 2, "model": 2},
          "d1m4": {"data": 1, "model": 4}}
EPOCH_CFG = {"state": "ERROR", "show_progress": False, "device": "cpu",
             "train_batch_size": 1024, "train_epochs": ["BOTH:1"]}
E2E_CFG = {**EPOCH_CFG, "streaming_topk_threshold": 1}
E2E_PATHS = {"device_loop": {}, "host_path": {"device_side_sampling": False},
             "dense_eval": {"streaming_topk_threshold": 1_000_000}}
#: the epoch's gradient clip: none, and one far below the gradients' norm
CLIPS = (None, 1e-3)


def _toy():
    rng = np.random.default_rng(0)
    params = {"user_embedding": rng.normal(size=(N_USERS, TOY_D)).astype(np.float32),
              "item_embedding": rng.normal(size=(N_ITEMS, TOY_D)).astype(np.float32)}
    batch = {"uid": rng.integers(0, N_USERS, TOY_B), "iid": rng.integers(0, N_ITEMS, TOY_B),
             "label": (rng.random(TOY_B) > 0.5).astype(np.float32)}
    return params, batch


def _topk_case():
    rng = np.random.default_rng(0)
    user_e = rng.normal(size=(TOPK_B, TOPK_D)).astype(np.float32)
    table = rng.normal(size=(TOPK_I, TOPK_D)).astype(np.float32)
    hist = np.sort(np.where(rng.random((TOPK_B, TOPK_H)) < 0.7,
                            rng.integers(1, TOPK_I, (TOPK_B, TOPK_H)), TOPK_I), axis=1)
    real = hist < TOPK_I
    row_ptr = np.concatenate([[0], np.cumsum(real.sum(1))]).astype(np.int32)
    return user_e, table, hist, row_ptr, hist[real].astype(np.int32)
"""
exec(_SHARED)

_PRELUDE = _SHARED + r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
OUT, RANK, PORT = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.trainer.device_loop import DeviceEpochLoop, TorchRandomSource
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import TrainMode
"""

_MESH_SCRIPT = _PRELUDE + r"""
from types import SimpleNamespace
from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator
from recbole_cdr_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_params
from recbole_cdr_tpu_torch.parallel.distributed import fetch_replicated

dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}", world_size=WORLD,
                        rank=RANK)
out = {}

# 1. one Adam step of the toy at 2 x 2
params, batch = _toy()
mesh = make_mesh(MESHES["d2m2"])


def toy_loss(p, b):
    logits = (p["user_embedding"][b["uid"]] * p["item_embedding"][b["iid"]]).sum(-1)
    per = torch.clamp(logits, min=0) - logits * b["label"] + torch.log1p(torch.exp(-logits.abs()))
    return per.mean()


step, holder, _ = make_sharded_train_step(
    toy_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2), mesh,
    {k: torch.from_numpy(v) for k, v in params.items()})
loss = step({k: torch.as_tensor(v) for k, v in batch.items()})
out["toy_loss"] = float(loss)
out["toy_shard_rows"] = {n: list(p.shape) for n, p in holder.named_parameters()}
np.savez(os.path.join(OUT, f"toy{RANK}.npz"), **fetch_replicated(holder, mesh))

# 2. B14's plain version through the evaluator's tile split, on three meshes
user_e, table, _, row_ptr, items = _topk_case()
for name, shape in MESHES.items():
    mesh = make_mesh(shape)
    L = -(-TOPK_I // mesh.model)
    padded = np.concatenate([table, np.random.default_rng(1).normal(
        size=(L * mesh.model - TOPK_I, TOPK_D)).astype(np.float32)])  # pad rows never win
    shard = torch.from_numpy(padded[mesh.model_index * L:(mesh.model_index + 1) * L])
    ids = FullSortEvaluator._sharded_tile(
        SimpleNamespace(max_k=TOPK_K), torch.from_numpy(user_e), shard, mesh.model_index * L,
        torch.from_numpy(row_ptr), torch.from_numpy(items), TOPK_I, mesh)
    out[f"topk_{name}"] = ids.tolist()

# 3. one device-loop epoch of CMF at 2 x 2, without and with a gradient clip
mesh = make_mesh(MESHES["d2m2"])
config = CDRConfig(model="CMF", config_dict=EPOCH_CFG, _cli_args=[])
init_seed(config["seed"], True)
dataset = CrossDomainDataset(config)
train_data, _, _ = data_preparation(config, dataset)
for clip in CLIPS:
    model = shard_params(CMF(config, dataset), mesh)
    out["epoch_shard_rows"] = {n: list(p.shape) for n, p in model.named_parameters()}
    opt = build_optimizer(config, model.parameters())
    step = make_train_step(model, opt, model.loss, lambda n: True, clip, mesh)
    loop = DeviceEpochLoop(TrainMode.BOTH, step, train_data, config["MODEL_INPUT_TYPE"], 1,
                           model.total_num_users, TorchRandomSource(config["seed"], "cpu"),
                           "cpu", mesh)
    out[f"epoch_loss_{clip}"] = float(loop.run_epoch(0))
    np.savez(os.path.join(OUT, f"epoch{RANK}_{clip}.npz"), **fetch_replicated(model, mesh))
dist.destroy_process_group()
json.dump(out, open(os.path.join(OUT, f"rank{RANK}.json"), "w"))
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    results = _spawn(_MESH_SCRIPT, out, _free_port())
    return out, results


def test_sharded_adam_step_matches_jax(mesh_run):
    out, results = mesh_run
    params, batch = _toy()

    def loss_fn(p, b):
        logits = jnp.sum(p["user_embedding"][b["uid"]] * p["item_embedding"][b["iid"]], -1)
        per = jnp.maximum(logits, 0) - logits * b["label"] + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        return per.mean()

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx = optax.adam(1e-2)
    loss, grads = jax.value_and_grad(lambda p: loss_fn(p, {k: jnp.asarray(v)
                                                           for k, v in batch.items()}))(jp)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    ref = optax.apply_updates(jp, updates)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["toy_loss"], float(loss), rtol=1e-5)
        assert res["toy_shard_rows"] == {"user_embedding": [N_USERS // 2, TOY_D],
                                         "item_embedding": [N_ITEMS // 2, TOY_D]}
        got = np.load(out / f"toy{r}.npz")
        for k in ref:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", [*MESHES, "one_process"])
def test_sharded_streaming_topk_plain_matches_jax(mesh_run, layout):
    user_e, table, hist, row_ptr, items = _topk_case()
    ref_s, ref_i = streaming_topk_with_history(jnp.asarray(user_e), jnp.asarray(table),
                                               jnp.asarray(hist), TOPK_K)
    if layout == "one_process":
        for m in (2, 3, 4):
            s, i = sharded_streaming_topk_plain(
                torch.from_numpy(user_e), torch.from_numpy(table), torch.from_numpy(row_ptr),
                torch.from_numpy(items), TOPK_K, m)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
            np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6)
        return
    for res in mesh_run[1]:
        np.testing.assert_array_equal(np.asarray(res[f"topk_{layout}"]), np.asarray(ref_i))


@pytest.mark.parametrize("clip", CLIPS)
def test_device_loop_epoch_mesh_matches_single_process(mesh_run, clip):
    """The second case clips every step's gradient to a norm far below its
    own, so the clip's global norm over the row shards decides each step."""
    out, results = mesh_run
    config = CDRConfig(model="CMF", config_dict=EPOCH_CFG, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = CrossDomainDataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    model = CMF(config, dataset)
    opt = build_optimizer(config, model.parameters())
    step = make_train_step(model, opt, model.loss, lambda n: True, clip)
    loop = DeviceEpochLoop(TrainMode.BOTH, step, train_data, config["MODEL_INPUT_TYPE"], 1,
                           model.total_num_users, TorchRandomSource(config["seed"], "cpu"),
                           "cpu")
    ref_loss = float(loop.run_epoch(0))
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"epoch_loss_{clip}"], ref_loss, rtol=1e-4)
        half = {n: -(-p.shape[0] // 2) for n, p in model.named_parameters()}
        assert res["epoch_shard_rows"] == {n: [half[n], p.shape[1]]
                                           for n, p in model.named_parameters()}
        got = np.load(out / f"epoch{r}_{clip}.npz")
        for n, p in model.named_parameters():
            np.testing.assert_allclose(got[n], p.detach().numpy(), rtol=1e-3, atol=1e-5)


# ---- the entry point at 2 x 2: one spawn -------------------------------------------

_E2E_SCRIPT = _PRELUDE + r"""
# the host path joins through torchrun's environment (distributed: auto),
# the others through the explicit dict
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[4], RANK=str(RANK),
                  WORLD_SIZE=str(WORLD))
joins = ({"coordinator_address": f"127.0.0.1:{PORT}", "num_processes": WORLD,
          "process_id": RANK}, "auto",
         {"coordinator_address": f"127.0.0.1:{sys.argv[5]}", "num_processes": WORLD,
          "process_id": RANK})
out = {}
for (name, extra), join in zip(E2E_PATHS.items(), joins):
    result = run_recbole_cdr(model="CMF", config_dict={
        **E2E_CFG, **extra, "mesh_shape": MESHES["d2m2"], "distributed": join})
    assert not dist.is_initialized()
    out[name] = result["test_result"]
json.dump(out, open(os.path.join(OUT, f"rank{RANK}.json"), "w"))
"""


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    return _spawn(_E2E_SCRIPT, tmp_path_factory.mktemp("e2e"), _free_port(), _free_port(),
                  _free_port())


@pytest.mark.parametrize("path", list(E2E_PATHS))
def test_run_recbole_cdr_mesh_matches_single_process(e2e_run, path):
    single = run_recbole_cdr(model="CMF", config_dict={**E2E_CFG, **E2E_PATHS[path]})
    want = single["test_result"]
    for res in e2e_run:
        assert res[path] == e2e_run[0][path]
        assert set(res[path]) == set(want)
        for k, v in want.items():
            assert abs(res[path][k] - v) < 0.02, (k, res[path][k], v)


# ---- what raises -------------------------------------------------------------------

_QUICK = {"state": "ERROR", "show_progress": False, "device": "cpu",
          "train_batch_size": 1024, "train_epochs": ["BOTH:1"]}
_ONE = {"mesh_shape": {"data": 1, "model": 1}}


@pytest.mark.parametrize("model,extra,error", [
    pytest.param("BiTGCF", _ONE, NotImplementedError, id="other-model"),
    pytest.param("CMF", {**_ONE, "phase_optimizer": "sparse"}, NotImplementedError,
                 id="sparse"),
    pytest.param("CMF", {**_ONE, "compute_dtype": "bfloat16"}, NotImplementedError,
                 id="bf16"),
    pytest.param("CMF", {"mesh_shape": {"data": 2, "model": 1}}, ValueError,
                 id="world-mismatch"),
])
def test_mesh_options_raise(model, extra, error):
    with pytest.raises(error, match="A13 remainder" if error is NotImplementedError
                       else "does not match"):
        run_recbole_cdr(model=model, config_dict={**_QUICK, **extra})
    assert not torch.distributed.is_initialized()
