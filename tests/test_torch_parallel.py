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
   The same epoch with ``phase_optimizer: sparse`` (B6's row-shard form's
   plain version on each rank's shards), in float32 within the same
   tolerance and in bfloat16 within one bf16 step (rtol 2^-8) of the
   port's single-process sparse epoch, the moments and step counts
   included; and ``Mesh.gather_occurrences`` on data slices of unequal
   length (data order, ``OCCURRENCE_PAD`` padding).
4. ``run_recbole_cdr`` for CMF at 2 x 2 with streaming forced, on the device
   loop (joined through the explicit ``distributed`` dict) and on the host
   batch path (``distributed: auto``, torchrun's environment variables),
   and with the dense evaluation (the tables gathered over ``model``):
   every rank returns the same test metrics, each within 0.02 of the
   single-process run. In the same spawn, over one process group the
   script creates: EMCDR's (SOURCE, TARGET, OVERLAP) and DCDCSR's (SOURCE,
   TARGET, BOTH, TARGET) whole schedules with dense Adam and with the
   sparse optimizer, and CMF's ``uniform 20`` candidate evaluation, held
   the same way.
5. What raises under ``mesh_shape``: a model that is not ``MESH_READY``
   (NotImplementedError), and a mesh that does not match the world
   (ValueError); what runs in one process over a one-rank group: the
   sparse optimizer and bfloat16 compute, with the metrics of the run
   without the mesh. ``full_table`` keeps a cast copy apart from the
   float32 gather of the same parameter version.
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
from recbole_cdr_tpu_torch.trainer.trainer import (
    SparseAdam,
    build_optimizer,
    make_sparse_train_step,
    make_train_step,
)
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from recbole_cdr_tpu_torch.utils.precision import resolve_compute_dtype

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
#: a trained state over the mesh against one process (``EPOCH_TOL`` of
#: ``tests/test_torch_sparse_adam.py``)
EPOCH_TOL = dict(rtol=5e-3, atol=1e-5)
#: the sparse epoch's compute types
SPARSE_DTYPES = ("float32", "bfloat16")
#: the data slices' lengths of the occurrence gather (rank = data index)
OCC_LENS = (3, 2)
_SCHEDULE = {"EMCDR": ["SOURCE:1", "TARGET:1", "OVERLAP:1"],
             "DCDCSR": ["SOURCE:1", "TARGET:1", "BOTH:1", "TARGET:1"]}
#: the runs of the entry point over one process group: (model, config)
MESH_RUNS = {
    "emcdr_dense": ("EMCDR", {"train_epochs": _SCHEDULE["EMCDR"]}),
    "emcdr_sparse": ("EMCDR", {"train_epochs": _SCHEDULE["EMCDR"],
                               "phase_optimizer": "sparse", "streaming_topk_threshold": 1}),
    "dcdcsr_dense": ("DCDCSR", {"train_epochs": _SCHEDULE["DCDCSR"],
                                "streaming_topk_threshold": 1}),
    "dcdcsr_sparse": ("DCDCSR", {"train_epochs": _SCHEDULE["DCDCSR"],
                                 "phase_optimizer": "sparse"}),
    "cmf_uniform": ("CMF", {"eval_args": {"split": {"RS": [0.8, 0.1, 0.1]},
                                          "group_by": "user", "order": "RO",
                                          "mode": "uniform 20"}}),
}


def entry_point_state(model, config_dict):
    # run_recbole_cdr of one of MESH_RUNS: (test metrics, [[phase, loss] per
    # epoch], {key: array} of the final parameters and buffers, each
    # row-sharded table gathered whole, and the optimizer's two moments,
    # {parameter: step count})
    import recbole_cdr_tpu_torch.quick_start.quick_start as quick_start
    from recbole_cdr_tpu_torch import run_recbole_cdr
    from recbole_cdr_tpu_torch.trainer.trainer import SparseAdam

    trainers = []
    get_trainer = quick_start.get_trainer

    def keep(*args):
        cls = get_trainer(*args)
        return lambda config, m: trainers.append(cls(config, m)) or trainers[-1]

    quick_start.get_trainer = keep
    try:
        result = run_recbole_cdr(model=model, config_dict=config_dict)
    finally:
        quick_start.get_trainer = get_trainer
    module, opt = result["model"], trainers[0].optimizer
    shards = getattr(module, "table_shards", {})

    def whole(name, t):
        t = t.detach()
        return (module.mesh.gather_rows(t)[:shards[name].rows] if name in shards else t).numpy()

    state = {f"param {n}": whole(n, p) for n, p in module.named_parameters()}
    state.update({f"buffer {n}": b.numpy() for n, b in module.named_buffers()})
    if isinstance(opt, SparseAdam):
        for moment in ("mu", "nu"):
            state.update({f"{moment} {n}": whole(n, t) for n, t in opt.state[moment].items()})
        counts = opt.state["count"]
    else:  # torch's Adam: the parameters it has stepped
        counts = {}
        for n, p in module.named_parameters():
            if p in opt.state:
                counts[n] = int(opt.state[p]["step"])
                for moment in ("exp_avg", "exp_avg_sq"):
                    state[f"{moment} {n}"] = whole(n, opt.state[p][moment])
    losses = [[h["phase"], h["loss"]] for h in result["history"]]
    return result["test_result"], losses, state, counts


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
from recbole_cdr_tpu_torch.trainer.trainer import (
    SparseAdam, build_optimizer, make_sparse_train_step, make_train_step)
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from recbole_cdr_tpu_torch.utils.precision import resolve_compute_dtype
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

# ... with the sparse optimizer, in float32 and bfloat16
for dtype in SPARSE_DTYPES:
    sconfig = CDRConfig(model="CMF", config_dict={**EPOCH_CFG, "phase_optimizer": "sparse",
                                                  "compute_dtype": dtype}, _cli_args=[])
    model = shard_params(CMF(sconfig, dataset), mesh)
    opt = SparseAdam(sconfig, model)
    step = make_sparse_train_step(model, opt, "BOTH", model.sparse_spec("BOTH"),
                                  lambda n: True, resolve_compute_dtype(sconfig))
    loop = DeviceEpochLoop(TrainMode.BOTH, step, train_data, sconfig["MODEL_INPUT_TYPE"], 1,
                           model.total_num_users, TorchRandomSource(sconfig["seed"], "cpu"),
                           "cpu", mesh)
    out[f"sparse_loss_{dtype}"] = float(loop.run_epoch(0))
    out[f"sparse_count_{dtype}"] = opt.state["count"]
    state = fetch_replicated(model, mesh)
    for moment in ("mu", "nu"):
        for n, t in opt.state[moment].items():
            state[f"{moment}:{n}"] = (mesh.gather_rows(t)[:model.table_shards[n].rows]
                                      if n in model.table_shards else t).numpy()
    np.savez(os.path.join(OUT, f"sparse{RANK}_{dtype}.npz"), **state)

# the occurrence gather over data slices of unequal length
n = OCC_LENS[mesh.data_index]
ids = torch.arange(n, dtype=torch.int32) + 10 * mesh.data_index
g_ids, g_rows = mesh.gather_occurrences(ids, ids[:, None].float().repeat(1, 2))
out["occurrences"] = [g_ids.tolist(), g_rows[:, 0].tolist()]
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
# the runs over one group this script creates and the runs leave in place
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[6]}",
                        world_size=WORLD, rank=RANK)
for name, (model, extra) in MESH_RUNS.items():
    test, losses, state, counts = entry_point_state(
        model, {**EPOCH_CFG, **extra, "mesh_shape": MESHES["d2m2"]})
    out[name] = {"test": test, "losses": losses, "counts": counts}
    np.savez(os.path.join(OUT, f"{name}{RANK}.npz"), **state)
dist.destroy_process_group()
json.dump(out, open(os.path.join(OUT, f"rank{RANK}.json"), "w"))
"""


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("e2e")
    return out, _spawn(_E2E_SCRIPT, out, _free_port(), _free_port(), _free_port(),
                       _free_port())


@pytest.mark.parametrize("path", list(E2E_PATHS))
def test_run_recbole_cdr_mesh_matches_single_process(e2e_run, path):
    single = run_recbole_cdr(model="CMF", config_dict={**E2E_CFG, **E2E_PATHS[path]})
    want = single["test_result"]
    results = e2e_run[1]
    for res in results:
        assert res[path] == results[0][path]
        assert set(res[path]) == set(want)
        for k, v in want.items():
            assert abs(res[path][k] - v) < 0.02, (k, res[path][k], v)


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_mesh_schedules_match_single_process(e2e_run, name):
    """EMCDR's and DCDCSR's whole schedules (per-phase freezing, DCDCSR's
    phase-entry surgery on gathered tables and its host-path BOTH, EMCDR's
    OVERLAP stream) with dense Adam and the sparse optimizer, and CMF's
    candidate evaluation with sharded parameters, at 2 x 2: every rank's test
    metrics within 0.02 of one process; each epoch's loss within rtol 1e-4;
    the step counts equal; the final parameters and buffers (the mapping MLP,
    DCDCSR's benchmark and affine tables) and the optimizer's moments within
    ``EPOCH_TOL``'s rtol, its atol taken relative to each array's largest
    entry (the second moments are some 1e-9)."""
    model, extra = MESH_RUNS[name]
    want, losses, state, counts = entry_point_state(model, {**EPOCH_CFG, **extra})
    out, results = e2e_run
    for r, res in enumerate(results):
        got = res[name]
        assert got["test"] == results[0][name]["test"]
        assert set(got["test"]) == set(want)
        for k, v in want.items():
            assert abs(got["test"][k] - v) < 0.02, (k, got["test"][k], v)
        assert [p for p, _ in got["losses"]] == [p for p, _ in losses]
        np.testing.assert_allclose([l for _, l in got["losses"]], [l for _, l in losses],
                                   rtol=1e-4)
        assert got["counts"] == counts
        arrays = np.load(out / f"{name}{r}.npz")
        assert set(arrays.files) == set(state)
        for key, v in state.items():
            np.testing.assert_allclose(arrays[key], v, rtol=EPOCH_TOL["rtol"],
                                       atol=EPOCH_TOL["atol"] * float(np.abs(v).max()),
                                       err_msg=key)


def _sparse_epoch(dtype):
    """The port's single-process sparse epoch of the spawn's CMF: (loss,
    model, optimizer)."""
    config = CDRConfig(model="CMF", config_dict={**EPOCH_CFG, "phase_optimizer": "sparse",
                                                 "compute_dtype": dtype}, _cli_args=[])
    init_seed(config["seed"], True)
    dataset = CrossDomainDataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    model = CMF(config, dataset)
    opt = SparseAdam(config, model)
    step = make_sparse_train_step(model, opt, "BOTH", model.sparse_spec("BOTH"),
                                  lambda n: True, resolve_compute_dtype(config))
    loop = DeviceEpochLoop(TrainMode.BOTH, step, train_data, config["MODEL_INPUT_TYPE"], 1,
                           model.total_num_users, TorchRandomSource(config["seed"], "cpu"),
                           "cpu")
    return float(loop.run_epoch(0)), model, opt, loop.steps_per_epoch


#: the sparse epoch's tolerance on the parameters: ``EPOCH_TOL`` in float32;
#: in bfloat16 one bf16 step, since a per-pair gradient whose float32 value
#: the mesh's batch sums move by an ulp may round to the neighbouring bf16
#: value
SPARSE_TOL = {"float32": EPOCH_TOL, "bfloat16": dict(rtol=2 ** -8, atol=1e-5)}


@pytest.mark.parametrize("dtype", SPARSE_DTYPES)
def test_sparse_epoch_mesh_matches_single_process(mesh_run, dtype):
    """One device-loop epoch of CMF with ``phase_optimizer: sparse`` at 2 x 2
    (row-shard B6 on the gathered occurrences) against one process: loss,
    parameters, both moments and the step counts."""
    out, results = mesh_run
    ref_loss, model, opt, steps = _sparse_epoch(dtype)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"sparse_loss_{dtype}"], ref_loss, rtol=1e-4)
        assert res[f"sparse_count_{dtype}"] == opt.state["count"]
        assert set(opt.state["count"].values()) == {steps}
        got = np.load(out / f"sparse{r}_{dtype}.npz")
        for n, p in model.named_parameters():
            np.testing.assert_allclose(got[n], p.detach().numpy(), **SPARSE_TOL[dtype],
                                       err_msg=n)
            for moment in ("mu", "nu"):
                np.testing.assert_allclose(got[f"{moment}:{n}"], opt.state[moment][n].numpy(),
                                           rtol=SPARSE_TOL[dtype]["rtol"], atol=1e-7,
                                           err_msg=f"{moment} {n}")


def test_gather_occurrences_keeps_the_data_order(mesh_run):
    """Slices of 3 and 2 occurrences (data ranks 0 and 1): every rank gets
    both, in data order, the short one padded with ``OCCURRENCE_PAD`` and a
    zero row."""
    from recbole_cdr_tpu_torch.parallel.mesh import OCCURRENCE_PAD

    want_ids = [0, 1, 2, 10, 11, OCCURRENCE_PAD]
    for res in mesh_run[1]:
        assert res["occurrences"] == [want_ids, [0.0, 1.0, 2.0, 10.0, 11.0, 0.0]]


# ---- what raises, and what runs over a one-rank group ------------------------------

_QUICK = {"state": "ERROR", "show_progress": False, "device": "cpu",
          "train_batch_size": 1024, "train_epochs": ["BOTH:1"]}
_ONE = {"mesh_shape": {"data": 1, "model": 1}}


@pytest.mark.parametrize("model,extra,error", [
    pytest.param("BiTGCF", _ONE, NotImplementedError, id="other-model"),
    pytest.param("CMF", {"mesh_shape": {"data": 2, "model": 1}}, ValueError,
                 id="world-mismatch"),
])
def test_mesh_options_raise(model, extra, error):
    with pytest.raises(error, match="A13 remainder" if error is NotImplementedError
                       else "does not match"):
        run_recbole_cdr(model=model, config_dict={**_QUICK, **extra})
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("extra", [
    pytest.param({"phase_optimizer": "sparse", "streaming_topk_threshold": 1}, id="sparse"),
    pytest.param({"compute_dtype": "bfloat16", "streaming_topk_threshold": 1}, id="bf16"),
])
def test_one_rank_mesh_options_run(extra):
    """The options that once raised under ``mesh_shape`` run over a
    one-rank gloo group in this process, with the metrics of the run without
    the mesh."""
    want = run_recbole_cdr(model="CMF", config_dict={**_QUICK, **extra})["test_result"]
    got = run_recbole_cdr(model="CMF", config_dict={**_QUICK, **extra, **_ONE})["test_result"]
    assert not torch.distributed.is_initialized()
    assert got == want


def test_full_table_is_kept_per_type():
    """A row-sharded table gathered in float32 and then read under a 16-bit
    compute in the same parameter version: the second read is the cast
    gather, not the float32 one from the cache (and the other way round)."""
    from types import SimpleNamespace

    from recbole_cdr_tpu_torch.parallel.mesh import TableShard
    from recbole_cdr_tpu_torch.utils.precision import with_compute_dtype

    config = CDRConfig(model="CMF", config_dict=_QUICK, _cli_args=[])
    init_seed(config["seed"], True)
    model = CMF(config, CrossDomainDataset(config))
    model.mesh = SimpleNamespace(gather_rows=lambda t: t.clone())
    model.table_shards = {"item_embedding": TableShard(model.item_embedding.shape[0], 0)}
    read = lambda: model.full_table("item_embedding")
    f32 = read()
    bf16 = with_compute_dtype(read, torch.bfloat16, model)()
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, model.item_embedding.detach().to(torch.bfloat16))
    assert read() is f32 and with_compute_dtype(read, torch.bfloat16, model)() is bf16
