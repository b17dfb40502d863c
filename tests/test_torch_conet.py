"""CoNet in the PyTorch port against the JAX model, on the CPU (where kernel
B15's wrapper runs its plain version), in both overlap modes: the bundled
ml-1m -> ml-100k pair overlaps on items, the small synthetic pair of
``tests/test_user_overlap.py`` on users. The same weights
(``params_from_jax``: ``target_tower.0.w``, ``cross.0``, ...) and, for the
epoch, the same random bits go to both. Tolerances, each with its case:

- the loss and every parameter's gradient on a batch: ``LOSS_TOL`` /
  ``GRAD_TOL`` (``tests/test_oracle_equivalence.py:31-32``);
- ``predict`` and the full-sort probabilities (``full_sort_fn``: B15's plain
  version on the split first layer) against JAX's ``predict_fn`` and
  ``full_sort_fn``: rtol 2e-4, atol 2e-5
  (``tests/test_oracle_equivalence.py::_check_full_sort``);
- one BOTH epoch with JAX's shuffle and negative bits: rtol 5e-3 / atol
  1e-5, the CMF epoch test's tolerance;
- the rows zeroed at init and the cross-stitch on overlapped rows only:
  exactly.
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_cdr_tpu.models.conet import CoNet as JaxCoNet

import recbole_cdr_tpu_torch.models.conet as conet_module
from recbole_cdr_tpu_torch import ops, run_recbole_cdr
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.models.conet import CoNet
from recbole_cdr_tpu_torch.ops.conet_tower import conet_tower, conet_tower_plain, packed_weights
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import get_model
from recbole_cdr_tpu_torch.utils.convert import params_from_jax
from test_torch_clfm import SCORE_TOL, check_predict, one_epoch_match, user_overlap_cfg
from test_torch_dcdcsr import assert_loss_and_grads_match, build_pair, phase_batch
from test_torch_model import _tbatch
from test_user_overlap import pair_root  # noqa: F401  (fixture)

MODES = ("overlap_items", "overlap_users")


@pytest.fixture(scope="module")
def items_pair():
    return build_pair("CoNet", JaxCoNet, CoNet)


@pytest.fixture(scope="module")
def users_pair(pair_root):  # noqa: F811
    return build_pair("CoNet", JaxCoNet, CoNet, user_overlap_cfg(pair_root))


@pytest.fixture(params=MODES)
def pair(request):
    m = request.getfixturevalue("items_pair" if request.param == "overlap_items"
                                else "users_pair")
    assert m["jmodel"].mode == m["tmodel"].mode == request.param
    return m


def test_get_model_resolves_conet():
    assert get_model("CoNet") is CoNet


def test_params_and_zeroed_rows(pair):
    """The port's parameters carry JAX's names; a fresh port model zeroes
    exactly the rows JAX's ``init_params`` zeroes (each domain's rows outside
    it) and no other row."""
    named = dict(pair["tmodel"].named_parameters())
    assert sorted(params_from_jax(pair["params"])) == sorted(named)
    assert {"target_tower.0.w", "target_out.b", "cross.0", "cross.3"} <= set(named)
    fresh = CoNet(pair["tconfig"], CrossDomainDataset(pair["tconfig"]))
    for name in ("source_user_embedding", "source_item_embedding", "target_user_embedding",
                 "target_item_embedding"):
        want = ~np.any(np.asarray(pair["params"][name]), axis=1)
        got = ~torch.any(getattr(fresh, name).detach() != 0, dim=1).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert want.any() and not want.all()


def test_cross_stitch_only_on_overlapped_rows(pair):
    """With the cross matrices zeroed, the towers' output changes exactly on
    the overlapped pairs (``user < overlapped_num_users`` or ``item <
    overlapped_num_items``: a strict ``<``) and nowhere else."""
    model = copy.deepcopy(pair["tmodel"])
    n = 64
    rng = np.random.default_rng(1)
    user = torch.from_numpy(rng.integers(1, model.total_num_users, n))
    item = torch.from_numpy(rng.integers(1, model.total_num_items, n))
    ent, n_ov = ((user, model.overlapped_num_users) if model.mode == "overlap_users"
                 else (item, model.overlapped_num_items))
    ent[:2] = torch.tensor([n_ov - 1, n_ov])
    overlap = ent < n_ov
    assert overlap[0] and not overlap[1] and overlap.any() and not overlap.all()
    with torch.no_grad():
        before = torch.cat(model._coupled_towers(user, item), 1)
        for c in model.cross:
            c.zero_()
        after = torch.cat(model._coupled_towers(user, item), 1)
    changed = (before != after).any(1)
    assert torch.equal(changed, overlap)


def test_conet_loss_and_grads_match_jax(pair):
    batch = phase_batch(pair["jtrain"], "BOTH")
    assert_loss_and_grads_match(pair["jmodel"], pair["params"], pair["tmodel"], "BOTH", batch)


def test_predict_matches_jax(pair):
    check_predict(pair)


def test_full_sort_matches_jax(pair):
    """The target tower over every target item through B15's plain version
    (the item half built once per parameter version) against JAX's
    ``full_sort_fn``; a training step rebuilds the item half."""
    jmodel, params = pair["jmodel"], pair["params"]
    model = copy.deepcopy(pair["tmodel"])
    users = np.arange(1, 41)
    want = np.asarray(jmodel.full_sort_fn("TARGET")(params, jnp.asarray(users)))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = model.full_sort_fn("TARGET")(torch.from_numpy(users))
        again = model.full_sort(torch.from_numpy(users[::-1].copy()))
    assert got.shape == want.shape == (len(users), model.target_num_items)
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)
    torch.testing.assert_close(again, got.flip(0), rtol=0, atol=0)
    assert not any(ops.launch_counts().values())  # plain on the CPU

    half = model._item_half()
    assert model._item_half() is half  # cached for the parameter version
    step = make_train_step(model, build_optimizer(pair["tconfig"], model.parameters()),
                           model.loss_fn("BOTH"), model.trainable_predicate("BOTH"))
    step(_tbatch(phase_batch(pair["jtrain"], "BOTH")))
    assert model._item_half() is not half
    assert not torch.equal(model._item_half(), half)


def test_tower_plain_chunks_and_padding(monkeypatch):
    """B15's plain version over more pairs than one chunk agrees with it in
    one chunk within 1e-6 (torch's CPU matmul rounds a row by its batch's
    shape); the padded weights the kernel reads hold the weights at the
    front of each row and zeros after."""
    import recbole_cdr_tpu_torch.ops.conet_tower as b15

    g = torch.Generator().manual_seed(0)
    hu, hi = torch.randn(5, 6, generator=g), torch.randn(23, 6, generator=g)
    layers = [(torch.randn(6, 5, generator=g), torch.randn(5, generator=g)),
              (torch.randn(5, 3, generator=g), torch.randn(3, generator=g))]
    out = (torch.randn(3, 1, generator=g), torch.randn(1, generator=g))
    whole = conet_tower(hu, hi, layers, out)
    monkeypatch.setattr(b15, "PAIR_BUDGET", 7)
    torch.testing.assert_close(conet_tower_plain(hu, hi, layers, out), whole, rtol=0, atol=1e-6)
    assert whole.shape == (5, 23)
    flat, widths = packed_weights(layers, out)
    assert widths == [8, 8, 4]
    W0 = flat[:64].reshape(8, 8)
    torch.testing.assert_close(W0[:6, :5], layers[0][0], rtol=0, atol=0)
    assert not W0[6:].any() and not W0[:, 5:].any()
    assert flat.numel() == 64 + 8 + 8 * 4 + 4 + 4 + 4


@pytest.mark.parametrize("mode", MODES)
def test_one_epoch_conet_parameter_match(mode, request):
    extra = {} if mode == "overlap_items" else {
        **user_overlap_cfg(request.getfixturevalue("pair_root")), "train_batch_size": 256}
    model, _ = one_epoch_match("CoNet", JaxCoNet, CoNet, extra)
    assert model.mode == mode


@pytest.mark.parametrize("mode", MODES)
def test_run_recbole_cdr_conet_on_cpu(mode, request, monkeypatch):
    """BOTH:1 with validation through the full-sort form, the item half
    built once per evaluation pass (the validation, then the test with the
    best parameters reloaded); finite metrics; no kernel launches on the
    CPU."""
    extra = {} if mode == "overlap_items" else user_overlap_cfg(request.getfixturevalue("pair_root"))
    builds = []
    real = conet_module.CoNet._item_half

    def counted(self):
        hit = self._version_cache.get("item_half")
        if hit is None or hit[0] != self.params_version:
            builds.append(self.params_version)
        return real(self)

    monkeypatch.setattr(conet_module.CoNet, "_item_half", counted)
    ops.reset_launch_counts()
    result = run_recbole_cdr(model="CoNet", config_dict={
        "state": "ERROR", "show_progress": False, "device": "cpu", "train_batch_size": 1024,
        "train_epochs": ["BOTH:1"], "eval_step": 1, **extra})
    assert result["model"].mode == mode
    assert all(math.isfinite(v) for v in result["test_result"].values())
    assert all(math.isfinite(h["loss"]) for h in result["history"])
    assert len(builds) == 2
    assert not any(ops.launch_counts().values())
