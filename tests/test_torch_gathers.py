"""The port's training gathers repeat bit for bit on the CPU.

Torch's CPU backward of an index gather (``table[ids]``) adds a row's
gradient rows by atomic adds over threads, in an order that can change from
run to run; ``F.embedding``'s adds them in an order the ids fix. Every
model's training gathers go through ``models/base.py::rows``
(``F.embedding``). Held here for the two that indexed last, DTCDR's NeuMF
(``_neumf_embeddings``) and SSCDR's triplet and OVERLAP losses: each case
runs twice with four torch threads, and its gradients (for the epoch, the
parameters they trained) must be equal bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from recbole_cdr_tpu_torch.config import CDRConfig
from recbole_cdr_tpu_torch.data.dataset import CrossDomainDataset
from recbole_cdr_tpu_torch.data.utils import data_preparation
from recbole_cdr_tpu_torch.models.dtcdr import DTCDR
from recbole_cdr_tpu_torch.models.sscdr import SSCDR
from recbole_cdr_tpu_torch.trainer import device_loop
from recbole_cdr_tpu_torch.trainer.trainer import build_optimizer, make_train_step
from recbole_cdr_tpu_torch.utils import init_seed
from recbole_cdr_tpu_torch.utils.enums import TrainMode

#: case -> (model, its class, config, phase); the batches are large enough
#: (ids x width above torch's grain of 32,768 elements) that the index
#: backward ran on several threads
CASES = {
    "neumf_epoch": ("DTCDR", DTCDR, {"base_model": "NeuMF", "train_batch_size": 2048},
                    "BOTH"),
    "sscdr_triplet": ("SSCDR", SSCDR, {"train_batch_size": 4096}, "SOURCE"),
    "sscdr_overlap": ("SSCDR", SSCDR, {"overlap_batch_size": 4096}, "OVERLAP"),
}


def _port(case):
    name, cls, extra, phase = CASES[case]
    config = CDRConfig(model=name, config_dict={"state": "ERROR", "device": "cpu", **extra},
                       _cli_args=[])
    init_seed(config["seed"], True)
    dataset = CrossDomainDataset(config)
    train_data, _, _ = data_preparation(config, dataset)
    model = cls(config, dataset)
    model.set_phase(phase)
    return config, model, train_data, phase


def _epoch(config, model, train_data, phase):
    """One epoch of the device loop from the model's weights (the plain
    kernels, the default random source from one seed): the trained
    parameters."""
    model = copy.deepcopy(model)
    step = make_train_step(model, build_optimizer(config, model.parameters()),
                           model.loss_fn(phase), lambda n: True)
    loop = device_loop.DeviceEpochLoop(
        TrainMode[phase], step, train_data, config["MODEL_INPUT_TYPE"], 1,
        model.total_num_users, device_loop.TorchRandomSource(0, "cpu"), "cpu")
    loop.run_epoch(0)
    return [p.detach().clone() for p in model.parameters()]


def _first_batch(model, train_data, phase):
    """The host loader's first batch of the phase (with SSCDR's neighbours)."""
    train_data.set_mode(TrainMode[phase])
    np.random.seed(0)  # the loaders shuffle with numpy's global state
    batch = model.augment_batch(next(iter(train_data)), phase)
    return {k: torch.from_numpy(np.asarray(v, np.int32 if v.dtype.kind == "i" else np.float32))
            for k, v in batch.items()}


def _gradients(model, batch, phase):
    """The phase's loss gradients on ``batch``."""
    model.zero_grad(set_to_none=True)
    model.loss_fn(phase)(batch).backward()
    return [p.grad.clone() for p in model.parameters() if p.grad is not None]


@pytest.mark.parametrize("case", list(CASES))
def test_training_gathers_repeat_across_threads(case):
    config, model, train_data, phase = _port(case)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        if case.endswith("epoch"):
            runs = [_epoch(config, model, train_data, phase) for _ in range(2)]
        else:
            batch = _first_batch(model, train_data, phase)
            runs = [_gradients(model, batch, phase) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    assert runs[0] and len(runs[0]) == len(runs[1])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
