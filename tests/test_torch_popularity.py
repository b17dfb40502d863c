"""Popularity training negatives (kernel B2a's plain version on the CPU)
against the JAX package.

- The port's alias arrays (``DomainDeviceData.alias``) equal JAX's for the
  same interaction counts.
- B2a: JAX's ``_sample_negatives(..., alias=...)`` and the port's
  ``sample_negatives_popularity`` fed the same ``jax.random.bits`` base and
  acceptance streams give exactly equal negatives (integer hashing and one
  float32 compare of exact values: no tolerance), with and without the
  heavy-user override (a uniform draw from the user's complement, under
  popularity too).
- The analogues of ``tests/test_device_loop.py:229-294``: the draws follow
  the popularity law on an empty history, avoid the user's history, and
  one device epoch of CMF (pointwise) and EMCDR BPR (pairwise) streams the
  JAX loop's batches bit-equal under JAX's bits; ``run_recbole_cdr`` trains
  both with finite metrics, CMF with adagrad and EMCDR with rmsprop.
- The two learners that come with popularity sampling in the queue (A3):
  adagrad and rmsprop in optax's form, one device epoch of CMF from the
  same weights and bits against JAX's optax chain (clip, weight decay,
  learner), to the Adam epoch test's tolerance (rtol 5e-3, atol 1e-5), and
  the epoch's update within 5e-3 of JAX's in norm; and
  ``phase_optimizer: single`` falls back to ``per_phase`` with JAX's
  warning.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_cdr_tpu.trainer.device_loop as jax_loop
from recbole_cdr_tpu.data.dataset import InteractionTable as JaxTable
from recbole_cdr_tpu.models.cmf import CMF as JaxCMF
from recbole_cdr_tpu.models.emcdr import EMCDR as JaxEMCDR
from recbole_cdr_tpu.sampler import DomainNegSampler as JaxSampler
from recbole_cdr_tpu.trainer.trainer import SingleOptimizer
from recbole_cdr_tpu.trainer.trainer import build_optimizer as jax_build_optimizer
from recbole_cdr_tpu.utils.enums import TrainMode as JaxTrainMode

import recbole_cdr_tpu_torch.trainer.device_loop as torch_loop
from recbole_cdr_tpu_torch import run_recbole_cdr
from recbole_cdr_tpu_torch.data.dataset import InteractionTable
from recbole_cdr_tpu_torch.models.cmf import CMF
from recbole_cdr_tpu_torch.models.emcdr import EMCDR
from recbole_cdr_tpu_torch.ops import launch_counts, reset_launch_counts
from recbole_cdr_tpu_torch.ops.neg_sampler import sample_negatives_popularity
from recbole_cdr_tpu_torch.sampler import DomainNegSampler
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils.enums import TrainMode
from test_torch_dcdcsr import build_pair
from test_torch_epoch import JaxRandomSource, _u32_as_i32, assert_streams_equal, recording

N_ITEMS = 41


def _tables(uids, iids):
    """The same (user, item) interactions as a JAX and a port table, with a
    popularity sampler each."""
    out = []
    for table_cls, sampler_cls in ((JaxTable, JaxSampler), (InteractionTable, DomainNegSampler)):
        table = table_cls({"target_user_id": np.asarray(uids, np.int64),
                           "target_item_id": np.asarray(iids, np.int64)},
                          uid_field="target_user_id", iid_field="target_item_id",
                          label_field="target_label", neg_prefix="neg_")
        sampler = sampler_cls(["train"], [table], num_items=N_ITEMS,
                              distribution="popularity").set_phase("train")
        out.append((table, sampler))
    return out


def _skewed():
    counts = {1: 32, 2: 16, 3: 8, 4: 4, 5: 2, 6: 2}
    iids = np.concatenate([np.full(c, i) for i, c in counts.items()])
    return counts, np.ones(len(iids), np.int64), iids


def test_alias_arrays_equal_jax():
    _, uids, iids = _skewed()
    (jt, js), (tt, ts) = _tables(uids, iids)
    jd = jax_loop.DomainDeviceData(jt, js, num_users=3)
    td = torch_loop.DomainDeviceData(tt, ts, 3, "cpu")
    for got, want in zip(td.alias, jd.alias):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(td.hist.numpy(), np.asarray(jd.hist))
    assert td.heavy is None and jd.heavy is None  # full-width history, as in JAX


@pytest.mark.parametrize("neg_num,heavy", [(1, False), (3, False), (2, True)])
def test_b2a_equals_jax_exactly(neg_num, heavy):
    """Users of random histories; with ``heavy``, the history matrix is cut
    to 4 columns and the heavy users take the uniform complement draw."""
    rng = np.random.default_rng(3)
    n_users = 30
    uids = rng.integers(1, n_users, 600)
    iids = rng.zipf(1.6, 600) % (N_ITEMS - 1) + 1  # skewed popularity over 1..40
    (jt, js), (tt, ts) = _tables(uids, iids)
    jd = jax_loop.DomainDeviceData(jt, js, num_users=n_users)
    td = torch_loop.DomainDeviceData(tt, ts, n_users, "cpu")
    hist = np.asarray(jd.hist)
    heavy_j = heavy_t = None
    if heavy:
        hist, heavy_uids = jax_loop._device_hist(js.used, n_users, 4)
        assert len(heavy_uids) > 3
        heavy_np = jax_loop._heavy_complements(js.used, heavy_uids, np.asarray(js.candidate_ids),
                                               n_users)
        heavy_j = tuple(jnp.asarray(a) for a in heavy_np)
        heavy_t = tuple(torch.from_numpy(np.asarray(a)) for a in heavy_np)
    batch_uids = rng.integers(0, n_users, 257).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_loop._sample_negatives(
        key, jnp.asarray(batch_uids), jnp.asarray(hist), jd.candidates, neg_num,
        alias=jd.alias, heavy=heavy_j))

    total = len(batch_uids) * neg_num
    bits = lambda k: _u32_as_i32(jax.random.bits(k, (total,), jnp.uint32))  # noqa: E731
    reset_launch_counts()
    t_uids = torch.from_numpy(batch_uids)
    got = sample_negatives_popularity(bits(key), bits(jax.random.fold_in(key, 1)), t_uids,
                                      torch.from_numpy(np.asarray(hist)), td.alias, neg_num)
    if heavy:
        data = SimpleNamespace(heavy=heavy_t)
        source = SimpleNamespace(heavy_bits=lambda *a: bits(jax.random.fold_in(key, 2)))
        loop = SimpleNamespace(neg_num=neg_num, source=source)
        got = torch_loop.DeviceEpochLoop._heavy_override(loop, data, "tgt", t_uids, got, 0, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["neg_sampler_popularity"] == 0  # the plain version on the CPU


def test_popularity_negatives_follow_the_law():
    """The draws of a user with an empty history follow the item
    popularities (rejection cannot distort them there)."""
    counts, uids, iids = _skewed()
    (_, _), (tt, ts) = _tables(uids, iids)
    td = torch_loop.DomainDeviceData(tt, ts, 3, "cpu")
    hist = torch.full((3, 1), N_ITEMS, dtype=torch.int32)  # user 2: empty history
    n = 16000
    g = torch.Generator().manual_seed(0)
    bits = lambda: torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32, generator=g)  # noqa: E731
    neg = sample_negatives_popularity(bits(), bits(), torch.full((n,), 2, dtype=torch.int32),
                                      hist, td.alias, 1).numpy()
    freq = np.bincount(neg, minlength=N_ITEMS)
    total_c = sum(counts.values())
    for item, c in counts.items():
        expected = n * c / total_c
        assert abs(freq[item] - expected) < expected * 0.2 + 30, (item, freq[item], expected)
    assert freq[7:].sum() == 0  # only interacted items have popularity mass


def test_popularity_negatives_avoid_history():
    """User 2's history is the low-mass item 5 (2 of 32 interactions): a
    false negative needs all 16 rounds to draw it, about 1e-20 a slot."""
    iids = np.concatenate([np.full(16, 1), np.full(8, 2), np.full(4, 3), [4, 4, 5, 5]])
    uids = np.ones(len(iids), np.int64)
    uids[-2:] = 2
    (_, _), (tt, ts) = _tables(uids, iids)
    td = torch_loop.DomainDeviceData(tt, ts, 3, "cpu")
    g = torch.Generator().manual_seed(4)
    bits = lambda: torch.randint(-2 ** 31, 2 ** 31, (4000,), dtype=torch.int32, generator=g)  # noqa: E731
    neg = sample_negatives_popularity(bits(), bits(), torch.full((4000,), 2, dtype=torch.int32),
                                      td.hist, td.alias, 1)
    assert bool((neg != 5).all())


@pytest.mark.parametrize("model,extra,phase", [
    ("CMF", {}, "BOTH"),
    ("EMCDR", {"loss_type": "BPR", "latent_factor_model": "BPR"}, "SOURCE"),
])
def test_popularity_stream_matches_jax(model, extra, phase):
    """One device epoch with popularity negatives: every step's batch
    bit-equal to the JAX DeviceEpochLoop's under JAX's bits, on the
    pointwise (CMF) and the pairwise (EMCDR BPR) stream."""
    classes = {"CMF": (JaxCMF, CMF), "EMCDR": (JaxEMCDR, EMCDR)}[model]
    m = build_pair(model, *classes, {**extra, "neg_sampling": {"popularity": 1}})
    jmodel, params = m["jmodel"], m["params"]
    base_rng = jax.random.PRNGKey(13)
    sopt = SingleOptimizer(m["jconfig"])
    seen = []
    jl = jax_loop.DeviceEpochLoop(
        JaxTrainMode[phase], recording(jmodel.loss_fn(phase), seen),
        sopt.for_phase(lambda k: True, list(params)), m["jtrain"],
        m["jconfig"]["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users, base_rng, donate=False)
    assert (jl.tgt if phase == "BOTH" else jl.src).alias is not None
    jax.block_until_ready(jl.run_epoch(params, sopt.init(params), 0))
    jax.effects_barrier()
    got = []

    def step(batch, rng=None):
        got.append({k: v.numpy().copy() for k, v in batch.items()})
        return torch.zeros(())

    tl = torch_loop.DeviceEpochLoop(TrainMode[phase], step, m["ttrain"],
                                    m["tconfig"]["MODEL_INPUT_TYPE"], 1,
                                    m["tmodel"].total_num_users, JaxRandomSource(base_rng),
                                    "cpu")
    tl.run_epoch(0)
    assert_streams_equal(seen, got)


@pytest.mark.parametrize("model,extra", [
    ("CMF", {"train_epochs": ["BOTH:2"], "learner": "adagrad", "phase_optimizer": "per_phase"}),
    ("EMCDR", {"train_epochs": ["SOURCE:2", "TARGET:1", "OVERLAP:1"], "loss_type": "BPR",
               "latent_factor_model": "BPR", "learner": "rmsprop",
               "phase_optimizer": "per_phase"}),
])
def test_run_recbole_cdr_popularity(model, extra):
    result = run_recbole_cdr(model=model, config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 1024,
        "neg_sampling": {"popularity": 1}, **extra})
    assert all(math.isfinite(v) for v in result["test_result"].values())
    losses = [h["loss"] for h in result["history"] if h["phase"] == result["history"][0]["phase"]]
    assert losses[-1] < losses[0]


# ------------------------------------------------------------------ learners

@pytest.mark.parametrize("learner", ["adagrad", "rmsprop"])
@pytest.mark.parametrize("extra", [{}, {"weight_decay": 1e-3,
                                        "clip_grad_norm": {"max_norm": 0.005}}])
def test_one_epoch_learner_matches_optax(learner, extra):
    """One device epoch of CMF under ``learner`` from the same weights and
    JAX's bits: the loss and both tables against JAX's optax chain. The
    ``max_norm`` 0.005 clips (a step's gradient norm is ~0.01)."""
    m = build_pair("CMF", JaxCMF, CMF, {"learner": learner, "learning_rate": 0.01, **extra})
    jmodel, params, tmodel = m["jmodel"], m["params"], m["tmodel"]
    tx = jax_build_optimizer(m["jconfig"], lambda k: True, list(params))
    base_rng = jax.random.PRNGKey(2)
    jl = jax_loop.DeviceEpochLoop(JaxTrainMode.BOTH, jmodel.loss_fn("BOTH"), tx, m["jtrain"],
                                  m["jconfig"]["MODEL_INPUT_TYPE"], 1, jmodel.total_num_users,
                                  base_rng, donate=False)
    jparams, _, jloss = jl.run_epoch(params, tx.init(params), 0)
    clip = extra.get("clip_grad_norm", {}).get("max_norm")
    step = make_train_step(tmodel, build_optimizer(m["tconfig"], tmodel.parameters()),
                           tmodel.loss_fn("BOTH"), lambda n: True, clip)
    tl = torch_loop.DeviceEpochLoop(TrainMode.BOTH, step, m["ttrain"],
                                    m["tconfig"]["MODEL_INPUT_TYPE"], 1,
                                    tmodel.total_num_users, JaxRandomSource(base_rng), "cpu")
    assert tl.steps_per_epoch == jl.steps_per_epoch >= 2
    np.testing.assert_allclose(float(tl.run_epoch(0)), float(jloss), rtol=5e-3, atol=1e-5)
    for name in ("user_embedding", "item_embedding"):
        got, want = getattr(tmodel, name).detach().numpy(), np.asarray(jparams[name])
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5, err_msg=name)
        # the epoch's update itself (adagrad's is small: its accumulator
        # starts at 0.1), in norm
        moved, moved_jax = got - params[name], want - params[name]
        assert np.linalg.norm(moved_jax) > 0
        err = np.linalg.norm(moved - moved_jax)
        assert err <= 5e-3 * np.linalg.norm(moved_jax), (name, err)


@pytest.mark.parametrize("learner", ["adagrad", "rmsprop"])
def test_single_optimizer_falls_back_to_per_phase(learner, caplog):
    """No shared-state form for these learners: ``single`` (the default)
    logs JAX's warning and trains per phase (``tests/test_single_optimizer.py
    :113-124`` for JAX)."""
    from recbole_cdr_tpu_torch.config import CDRConfig
    from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
    from recbole_cdr_tpu_torch.trainer.trainer import CrossDomainTrainer

    config = CDRConfig(model="CMF", config_dict={"state": "ERROR", "device": "cpu",
                                                 "learner": learner}, _cli_args=[])
    with caplog.at_level("WARNING"):
        trainer = CrossDomainTrainer(config, CMF(config, CrossDomainDataset(config)))
    assert trainer.per_phase
    assert "falling back to per_phase" in caplog.text
    result = run_recbole_cdr(model="CMF", config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 1024,
        "train_epochs": ["BOTH:1"], "learner": learner})
    assert math.isfinite(result["test_result"]["mrr@10"])
