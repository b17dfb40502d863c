"""One BOTH-phase epoch of the port's DeviceEpochLoop (torch Adam, plain
versions of K1-K3 on the CPU) against the JAX DeviceEpochLoop
(``SingleOptimizer``, torch-exact Adam) from the same weights, with JAX's
random bits injected through the port's random-source interface: the epoch
shuffles and negatives are then identical and the parameters must agree to
the one-epoch tolerance of ``test_one_epoch_adam_parameter_match``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.config import CDRConfig as JaxConfig
from recbole_cdr_tpu.data.dataset import CrossDomainDataset as JaxDataset
from recbole_cdr_tpu.data.utils import data_preparation as jax_data_preparation
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.utils import init_seed as jax_init_seed
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from recbole_cdr_tpu_torch.utils.enums import TrainMode


def _u32_as_i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def jax_dropout_draw(r_loss):
    """The dropout bits a JAX model's loss draws from its step key
    ``r_loss`` (``models/bitgcf.py:159-164``: per layer ``rng, r1, r2 =
    split(rng, 3)``, r1 for the source graph, r2 for the target), served as
    the port's per-step ``rng(layer, domain, shape)``."""
    def draw(layer, domain, shape):
        rng = r_loss
        for _ in range(layer + 1):
            rng, r1, r2 = jax.random.split(rng, 3)
        key = {"src": r1, "tgt": r2}[domain]
        return _u32_as_i32(jax.random.bits(key, tuple(shape), jnp.uint32))
    return draw


class JaxRandomSource:
    """The random draws of the JAX DeviceEpochLoop (run_epoch /
    run_one_epoch / build_xs / _sample_negatives, and the step key its loss
    gets), served through the port's random-source interface."""

    def __init__(self, base_rng):
        self.base_rng = base_rng

    def _epoch(self, epoch):
        return jax.random.fold_in(self.base_rng, epoch)

    def shuffle_keys(self, epoch, domain, n, shape=()):
        r_s, r_t, r_o = jax.random.split(jax.random.fold_in(self._epoch(epoch), 0xC0FFEE), 3)
        keys, salts = jax_loop._shuffle_keys({"src": r_s, "tgt": r_t, "over": r_o}[domain], n,
                                             tuple(shape))
        return torch.from_numpy(np.asarray(keys).copy()), _u32_as_i32(salts)

    def _neg_rng(self, epoch, domain, step_lo):
        r_neg = jax.random.fold_in(self._epoch(epoch), 0x5EED)
        r_src, r_tgt = jax.random.split(jax.random.fold_in(r_neg, step_lo))
        return {"src": r_src, "tgt": r_tgt}[domain]

    def negative_bits(self, epoch, domain, step_lo, total):
        return _u32_as_i32(jax.random.bits(self._neg_rng(epoch, domain, step_lo),
                                           (total,), jnp.uint32))

    def heavy_bits(self, epoch, domain, step_lo, total):
        rng = jax.random.fold_in(self._neg_rng(epoch, domain, step_lo), 2)
        return _u32_as_i32(jax.random.bits(rng, (total,), jnp.uint32))

    def dropout_bits(self, epoch, step, layer, domain, shape):
        # the loss gets fold_in(fold_in(base, epoch), step) (device_loop.py:592,771)
        r_loss = jax.random.fold_in(self._epoch(epoch), step)
        return jax_dropout_draw(r_loss)(layer, domain, shape)


@pytest.mark.parametrize("hist_cap", [None, 12])
def test_one_epoch_adam_parameter_match(hist_cap, monkeypatch):
    """``hist_cap=12`` truncates the history matrix so that many users are
    heavy and take the exact-complement override in both packages."""
    if hist_cap is not None:
        monkeypatch.setattr(jax_loop, "HIST_WIDTH_CAP", hist_cap)
        monkeypatch.setattr(torch_loop, "HIST_WIDTH_CAP", hist_cap)
    cfg = {"state": "ERROR", "train_batch_size": 1024, "device": "cpu",
           "train_epochs": ["BOTH:1"]}
    base_rng = jax.random.PRNGKey(1)

    jconfig = JaxConfig(model="CMF", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxCMF(jconfig, jdataset)
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    sopt = SingleOptimizer(jconfig)
    tx = sopt.for_phase(lambda k: True, list(params0))
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), tx, jtrain,
        jconfig["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng,
        donate=False,
    )
    if hist_cap is not None:
        assert jl.src.heavy is not None and jl.tgt.heavy is not None
    jparams, _, jloss = jl.run_epoch(params0, sopt.init(params0), 0)

    tconfig = CDRConfig(model="CMF", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    tdataset = CrossDomainDataset(tconfig)
    ttrain, _, _ = data_preparation(tconfig, tdataset)
    model = CMF(tconfig, tdataset)
    model.load_state_dict(params_from_jax(jax.device_get(params0)))
    step = make_train_step(model, build_optimizer(tconfig, model.parameters()),
                           model.loss_fn("BOTH"), lambda n: True)
    tl = torch_loop.DeviceEpochLoop(
        TrainMode.BOTH, step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, JaxRandomSource(base_rng), "cpu",
    )
    assert (tl.steps_per_epoch, tl.seg_steps) == (jl.steps_per_epoch, jl.seg_steps)
    tloss = tl.run_epoch(0)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-3, atol=1e-5)
    for name in ("user_embedding", "item_embedding"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(jparams[name]), rtol=5e-3, atol=1e-5,
                                   err_msg=name)


def recording(loss_fn, seen):
    """``loss_fn`` that also appends every step's batch, as numpy, to
    ``seen`` in step order (an ordered host callback inside the JAX epoch's
    scan)."""
    def loss(params, batch, rng=None):
        jax.debug.callback(lambda b: seen.append({k: np.asarray(v) for k, v in b.items()}),
                           dict(batch), ordered=True)
        return loss_fn(params, batch, rng)
    return loss


def assert_streams_equal(jax_batches, torch_batches):
    """The two loops' batches, step by step: the same fields, bit-equal."""
    assert len(torch_batches) == len(jax_batches) >= 2
    for step, (j, t) in enumerate(zip(jax_batches, torch_batches)):
        assert sorted(j) == sorted(t), (step, sorted(j), sorted(t))
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"step {step} {k}")


@pytest.mark.parametrize("phase", ["SOURCE", "TARGET"])
def test_pairwise_stream_matches_jax(phase):
    """One epoch of a PAIRWISE phase (DCDCSR's BPR): every step's users,
    positives, ``neg_<item id>`` column and weights bit-equal to the JAX
    DeviceEpochLoop's under JAX's bits, and no label field."""
    from recbole_cdr_tpu.models.dcdcsr import DCDCSR as JaxDCDCSR

    cfg = {"state": "ERROR", "train_batch_size": 512, "device": "cpu"}
    base_rng = jax.random.PRNGKey(5)
    jconfig = JaxConfig(model="DCDCSR", config_dict=cfg, _cli_args=[])
    jax_init_seed(jconfig["seed"], True)
    jdataset = JaxDataset(jconfig)
    jtrain, _, _ = jax_data_preparation(jconfig, jdataset)
    jmodel = JaxDCDCSR(jconfig, jdataset)
    params0 = jmodel.init_params(jax.random.PRNGKey(7))
    assert jconfig["MODEL_INPUT_TYPE"].name == "PAIRWISE"
    sopt = SingleOptimizer(jconfig)
    seen = []
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode[phase], recording(jmodel.loss_fn(phase), seen),
        sopt.for_phase(lambda k: True, list(params0)), jtrain, jconfig["MODEL_INPUT_TYPE"], 1,
        jmodel.total_num_users, base_rng, donate=False)
    jax.block_until_ready(jl.run_epoch(params0, sopt.init(params0), 0))
    jax.effects_barrier()

    tconfig = CDRConfig(model="DCDCSR", config_dict=cfg, _cli_args=[])
    init_seed(tconfig["seed"], True)
    ttrain, _, _ = data_preparation(tconfig, CrossDomainDataset(tconfig))
    got = []

    def step(batch, rng=None):
        got.append({k: v.numpy().copy() for k, v in batch.items()})
        return torch.zeros(())

    tl = torch_loop.DeviceEpochLoop(
        TrainMode[phase], step, ttrain, tconfig["MODEL_INPUT_TYPE"], 1,
        jmodel.total_num_users, JaxRandomSource(base_rng), "cpu")
    tl.run_epoch(0)
    assert tl.examples_per_step == tl.step
    assert not any(k.endswith("label") for k in got[0])
    assert_streams_equal(seen, got)
