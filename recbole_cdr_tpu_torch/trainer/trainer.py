"""Phase-scheduled trainer: the four-mode schedule over the device epoch loop
or the host batch path.

Port of ``recbole_cdr_tpu/trainer/trainer.py::CrossDomainTrainer`` (itself
capability parity with `recbole_cdr/trainer/trainer.py:19-137` plus the
inherited recbole ``Trainer`` epoch loop): per phase, reset early stopping,
flip the dataloader mode and model phase, let the model rebuild its derived
tables (``mutate_params_on_phase``), run epochs, validate every
``eval_step`` epochs, stop after ``stopping_step`` non-improving
validations, keep the best parameters in memory, and finally evaluate with
them.

A phase runs on the device epoch loop (``trainer/device_loop.py``) unless
``device_side_sampling`` is False, the training negatives are drawn by a
distribution the loop does not take, or the model needs a host hook in the
phase (``needs_host_augment``: DCDCSR's BOTH, SSCDR's OVERLAP); such a phase
iterates the host loader (``data/batching.py::CrossDomainLoader``), passes
every batch through ``model.augment_batch``, moves it to the trainer's
device and takes one optimizer step per batch (the JAX trainer's
``_fit_phase``, whose ``steps_per_call`` stacking is a TPU dispatch
optimisation with no counterpart here). :class:`DCDCSRTrainer` runs no
validation in the BOTH phase.

The optimizer is ``torch.optim.Adam`` (or SGD), built once per trainer by
default (``phase_optimizer: single``, recbole semantics): Adam's state is
per parameter and created lazily, so a parameter frozen in one phase (its
grad set to None) keeps its moments and step count for a later phase — the
behaviour the JAX package's ``SingleOptimizer`` emulates. Order within a
step: clip the raw grads, then L2 weight decay (inside the optimizer), then
the update.

``phase_optimizer: sparse`` (or ``single`` with ``learner: sparse_adam``)
trains with :class:`SparseAdam` instead: torch.optim.SparseAdam semantics on
the tables the model declares in ``sparse_spec``, whose gradients are taken
with respect to the gathered rows (no [N, D] gradient exists) and applied by
kernel B6 (``ops/sparse_adam.py``); other parameters, and phases without a
spec, get dense torch-Adam on the same shared moments.

Labeled eval sets go to :class:`ValueEvaluator` and candidate-ranking ones
to ``FullSortEvaluator.evaluate_candidates``, both scoring through the
model's ``predict``. Full-sort evaluation streams the item axis through
kernel B5 (``ops/topk.py``) when the item space reaches
``streaming_topk_threshold`` and the model has dot-product factors;
otherwise it takes the dense path, scoring with the model's full-sort form
or, in a phase where the model has none (NATR's target phases, DTCDR), with
:func:`make_predict_full_sort`.

``compute_dtype: bfloat16`` (or float16) runs every loss, predict,
full-sort and factors function on 16-bit copies of the model's floating
parameters and buffers (``utils/precision.py``), where the JAX trainer
wraps them; parameters and optimizer state stay float32.

``log_wandb`` logs each epoch's loss (``train/<phase>_loss``) and each
validation's metrics (``valid/<metric>``) to Weights & Biases when the
``wandb`` package imports, and warns "wandb logging disabled: ..." when it
does not, as the JAX trainer does.

``mesh_shape`` (with ``distributed`` for more than one process) trains
CMF, EMCDR and DCDCSR (``MESH_READY``) over a (data, model) mesh of
processes (``parallel/mesh.py``): the tables are padded and row-sharded at
construction, every rank draws the global batch stream and trains on its
``data`` slice, the loss takes its batch sums over the data group, and after
the backward the gradients are summed over it (``clip_grad_norm`` takes the
norm over the whole sharded tables); under ``phase_optimizer: sparse`` the
step's occurrences and their gradient rows are gathered over the data group
instead and each rank updates the rows of its shards (B6's row-shard form).
A 16-bit ``compute_dtype`` casts this rank's shards. Evaluation passes the
mesh, so the streaming path runs B14. Under the mesh the other models raise
(ROADMAP.md A13 remainder).

Not ported yet, and raising when configured: checkpoint files and resume
(ROADMAP.md A12), profiling (A12).
"""

import functools
import time
from logging import getLogger

import numpy as np
import torch

from recbole_cdr_tpu_torch.evaluator.evaluator import FullSortEvaluator, ValueEvaluator
from recbole_cdr_tpu_torch.parallel.distributed import is_coordinator, put_replicated, put_sharded
from recbole_cdr_tpu_torch.parallel.mesh import make_mesh, shard_params
from recbole_cdr_tpu_torch.ops.row_groups import RowPlan, group_rows
from recbole_cdr_tpu_torch.ops.sparse_adam import adam_step_size, sparse_adam
from recbole_cdr_tpu_torch.trainer.device_loop import (
    DeviceEpochLoop,
    TorchRandomSource,
    rebase_sparse_batch,
)
from recbole_cdr_tpu_torch.utils import resolve_device, set_color
from recbole_cdr_tpu_torch.utils.enums import train_mode2state
from recbole_cdr_tpu_torch.utils.precision import (
    call_with,
    resolve_compute_dtype,
    with_compute_dtype,
)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad`` (optax 0.2.6: ``scale_by_rss`` then the learning
    rate), which torch.optim.Adagrad does not match: the accumulator starts
    at ``initial_accumulator_value`` 0.1, and the update is
    ``g * rsqrt(acc + eps)`` with eps 1e-7 inside the root, 0 where acc is
    0. ``weight_decay`` adds ``wd * p`` to the gradient first
    (``optax.add_decayed_weights``). Parameters without a gradient are
    skipped, as torch's optimizers skip them."""

    def __init__(self, params, lr, weight_decay=0.0, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  "initial_accumulator_value": initial_accumulator_value,
                                  "eps": eps})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"],
                        memory_format=torch.preserve_format)
                acc = state["sum_of_squares"]
                acc.copy_(g * g + acc)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), 0.0)
                p.add_(-group["lr"] * (scale * g))


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (optax 0.2.6: ``scale_by_rms`` then the learning
    rate), which torch.optim.RMSprop does not match: the second moment
    starts at ``initial_scale`` 0 and decays by 0.9, and eps 1e-8 sits
    inside the root, ``g * rsqrt(nu + eps)``. ``weight_decay`` and skipped
    parameters as in :class:`OptaxAdagrad`."""

    def __init__(self, params, lr, weight_decay=0.0, decay=0.9, eps=1e-8, initial_scale=0.0):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay, "decay": decay,
                                  "eps": eps, "initial_scale": initial_scale})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"],
                                                  memory_format=torch.preserve_format)
                decay = group["decay"]
                nu = state["nu"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                p.add_(-group["lr"] * (torch.rsqrt(nu + group["eps"]) * g))


#: learners without a shared-state form: ``phase_optimizer: single`` falls
#: back to ``per_phase`` for them, as the JAX trainer's ``SingleOptimizer``
#: refuses them (``recbole_cdr_tpu/trainer/trainer.py:95-101,485-492``)
PER_PHASE_LEARNERS = ("adagrad", "rmsprop")


def build_optimizer(config, params) -> torch.optim.Optimizer:
    """torch optimizer mirroring recbole's learner/learning_rate/weight_decay
    settings (weight decay as the L2 term added to the grad); adagrad and
    rmsprop in optax's form, as the JAX package builds them."""
    learner = (config["learner"] or "adam").lower()
    lr = float(config["learning_rate"])
    weight_decay = float(config["weight_decay"] or 0.0)
    if learner in ("adam", "sparse_adam"):  # per_phase sparse_adam: dense Adam, as in JAX
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if learner == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
    if learner == "adagrad":
        return OptaxAdagrad(params, lr=lr, weight_decay=weight_decay)
    if learner == "rmsprop":
        return OptaxRMSprop(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"learner [{learner}] is not supported: use adam, sgd, adagrad, "
                     "rmsprop or sparse_adam")


def phase_loss(model, phase):
    """``(batch, rng=None) -> loss`` that looks the phase's loss up at every
    call, through the model's ``forward``: under a substitution of the
    model's tensors (a cast, the sparse step's sub-tables) the loss must read
    the substitutes, and a model may bind its tables when it builds the loss
    (DCDCSR's second TARGET phase)."""
    return lambda batch, rng=None: model(batch, phase, rng)


def make_train_step(model, optimizer, loss_fn, trainable, clip=None, mesh=None):
    """``(batch, rng=None) -> loss`` performing one optimizer step (``rng``:
    the step's random draw, see ``CrossDomainRecommender.loss_fn``).
    Parameters whose top-level name fails ``trainable`` get ``grad = None``
    before the step, so torch's optimizers leave them and their state
    untouched. Under ``mesh`` the gradients are summed over the data group
    first, and the clip takes the norm over the whole sharded tables."""
    named = list(model.named_parameters())
    frozen = [p for n, p in named if not trainable(n.split(".", 1)[0])]
    live = [(n, p) for n, p in named if trainable(n.split(".", 1)[0])]
    params = [p for _, p in live]

    def step(batch, rng=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, rng)
        loss.backward()
        for p in frozen:
            p.grad = None
        if mesh is not None:
            mesh.reduce_gradients(params)
            if clip is not None:
                mesh.clip_grad_norm_(live, clip, model.table_shards)
        elif clip is not None:
            torch.nn.utils.clip_grad_norm_([p for p in params if p.grad is not None], clip)
        optimizer.step()
        model.notify_params_updated()
        return loss.detach()

    return step


class SparseAdam:
    """torch.optim.SparseAdam semantics for embedding tables, with one
    ``{"mu", "nu", "count"}`` state per parameter shared across phases.

    Port of ``recbole_cdr_tpu/trainer/trainer.py::SparseAdam``:

    - a table's step count ticks once per optimizer step, touched rows or
      not;
    - only the rows present in a step's gradient (duplicates coalesced by
      summation) update their moments and receive an update; untouched rows
      keep stale moments ("lazy");
    - ``denom = sqrt(nu) + eps`` with both bias corrections folded into the
      step size (not the dense-Adam form, where eps is added after
      ``sqrt(nu / bc2)``);
    - weight_decay and gradient clipping are rejected.

    Tables in the model's ``sparse_spec`` take :meth:`row_update` (kernel B6
    on the card); every other trainable parameter takes
    :meth:`dense_entry_update`, torch's dense Adam on the same state. Under a
    mesh a row-sharded table's moments and scratch are its shard's, and
    :meth:`step_table` takes the step's global occurrences and updates the
    shard's rows of them (B6's row-shard form)."""

    def __init__(self, config, model):
        learner = (config["learner"] or "adam").lower()
        if learner not in ("adam", "sparse_adam"):
            raise ValueError(
                f"phase_optimizer: 'sparse' supports adam/sparse_adam, got '{learner}'"
            )
        if float(config["weight_decay"] or 0.0) != 0.0:
            raise ValueError(
                "phase_optimizer: 'sparse' rejects weight_decay (as "
                "torch.optim.SparseAdam does)"
            )
        if config["clip_grad_norm"]:
            raise ValueError(
                "phase_optimizer: 'sparse' does not support clip_grad_norm "
                "(clipping needs the global grad norm, which defeats the "
                "row-sparse update)"
            )
        self.lr = float(config["learning_rate"])
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.params = dict(model.named_parameters())
        self.state = {
            "mu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()},
            "nu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in self.params.items()},
            "count": {n: 0 for n in self.params},
        }
        #: the kept plan of each table's (or shard's) grouping of a step's ids
        #: (``ops/row_groups.py::RowPlan``), so a step costs O(rows touched),
        #: not O(rows), and one C call
        self._row_plans = {}
        #: the first global row of each row-sharded table's shard
        self.row_offsets = {n: s.offset for n, s in getattr(model, "table_shards", {}).items()}

    def row_update(self, p, mu, nu, g_rows, ids, c, groups=None, row_offset=0):
        """One SparseAdam step for one table, in place: ``g_rows[j]`` is the
        grad of global row ``ids[j]`` (duplicates allowed; rows outside
        ``p``'s ``[row_offset, row_offset + len(p))`` skipped), ``c`` the
        table's step count after this step's increment; ``groups`` the ids'
        grouping over those rows (``group_rows``; the card needs it)."""
        sparse_adam(p, mu, nu, g_rows, ids, adam_step_size(self.lr, self.b1, self.b2, c),
                    self.b1, self.b2, self.eps, groups=groups, row_offset=row_offset)

    def dense_entry_update(self, g, mu, nu, c):
        """torch dense-Adam step for one parameter: returns (update, mu, nu),
        bias corrections in float32 as in the JAX package."""
        f = np.float32
        bc1 = float(f(1.0) - f(self.b1) ** f(c))
        bc2 = float(f(1.0) - f(self.b2) ** f(c))
        mu2 = self.b1 * mu + (1.0 - self.b1) * g
        nu2 = self.b2 * nu + (1.0 - self.b2) * (g * g)
        upd = -self.lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + self.eps)
        return upd, mu2, nu2

    @torch.no_grad()
    def step_table(self, name, g_rows, ids):
        p = self.params[name]
        offset, groups = self.row_offsets.get(name, 0), None
        if p.device.type == "cuda":  # the plain version on the CPU reads the ids
            plan = self._row_plans.get(name)
            if plan is None:
                plan = self._row_plans[name] = RowPlan(p.shape[0], p.device, offset,
                                                       ids.shape[0])
            groups = group_rows(ids, plan)
        self.state["count"][name] += 1
        self.row_update(p.data, self.state["mu"][name], self.state["nu"][name],
                        g_rows, ids, self.state["count"][name], groups, offset)

    @torch.no_grad()
    def step_dense(self, name, grad):
        p = self.params[name]
        if grad is None:  # unused in the loss: JAX's grad is zeros
            grad = torch.zeros_like(p)
        self.state["count"][name] += 1
        upd, self.state["mu"][name], self.state["nu"][name] = self.dense_entry_update(
            grad, self.state["mu"][name], self.state["nu"][name], self.state["count"][name])
        p.add_(upd)


def make_sparse_train_step(model, optimizer, phase, spec, trainable,
                           compute_dtype=torch.float32):
    """``(batch, rng=None) -> loss`` performing one :class:`SparseAdam` step. The loss
    runs (``torch.func.functional_call``) on [R, D] sub-tables gathered from
    the tables of ``spec`` at the batch's ids, with the ids re-based onto
    them, so the gradients are [R, D] rows and no [N, D] table gradient is
    allocated; kernel B6 then updates the touched rows. Parameters outside
    ``spec`` that pass ``trainable`` take a dense Adam step; the rest stay
    frozen. With an empty ``spec`` this is the dense fallback of a phase
    without one. Under a 16-bit ``compute_dtype`` the loss runs on cast
    copies of the sub-tables and the other parameters; the row gradients
    come back float32 through the cast.

    Under the model's mesh the batch is this rank's data slice: the
    sub-tables are gathered once through the row-sharded lookup and the loss
    runs with those tables' shards suspended (``rows`` then reads the
    sub-tables), taking its batch sums over the data group; after the
    backward each table's occurrences and gradient rows are gathered over
    the data group in the global order and B6's row-shard form updates this
    rank's rows of them, and the dense entries' gradients are summed over
    the data group first."""
    named = dict(model.named_parameters())
    top = lambda n: n.split(".", 1)[0]
    rest = [n for n in named if top(n) not in spec]
    dense = [n for n in rest if trainable(top(n))]
    loss_fn = with_compute_dtype(phase_loss(model, phase), compute_dtype, model)
    mesh = model.mesh

    def step(batch, rng=None):
        batch2, idx = rebase_sparse_batch(batch, spec)
        with torch.no_grad():
            sub = {n: model.rows(n, idx[n]) for n in spec}
        for t in sub.values():
            t.requires_grad_()
        with model.sub_tables(spec):
            loss = call_with(model, sub, loss_fn, batch2, rng)
        loss.backward()
        for n in spec:
            ids, g_rows = idx[n], sub[n].grad
            if mesh is not None:
                ids, g_rows = mesh.gather_occurrences(ids, g_rows)
            optimizer.step_table(n, g_rows, ids)
        if mesh is not None:
            mesh.reduce_gradients(named[n] for n in dense)
        for n in dense:
            optimizer.step_dense(n, named[n].grad)
        for n in rest:
            named[n].grad = None
        model.notify_params_updated()
        return loss.detach()

    return step


def make_predict_full_sort(model, item_num, compute_dtype=torch.float32):
    """Full-sort scores through the model's pair predictions, for a phase
    where it has no full-sort form (recbole's repeated-predict fallback).

    Port of ``recbole_cdr_tpu/trainer/trainer.py:337-385``: the users' grid
    over the whole item axis goes to ``model.predict_grid``, whose default
    scores it chunk by chunk as pairs through ``predict``, as JAX's scan
    does; a model that shares work between the pairs of a grid scores it in
    one call. The function carries ``_pair_cost``: each score costs a
    prediction, not a dot product, and the evaluator budgets its tiles by
    that. The predictions run in ``compute_dtype``
    (``make_predict_full_sort(compute_dtype=)``, JAX :338-355)."""
    predict_grid = with_compute_dtype(model.predict_grid, compute_dtype, model)

    def full_sort(users):
        return predict_grid(users, torch.arange(item_num, device=users.device))

    full_sort._pair_cost = True
    return full_sort


def eval_users(eval_data) -> int:
    """The users an eval set covers (a labeled set's distinct users)."""
    if hasattr(eval_data, "uid_list"):
        return len(eval_data.uid_list)
    return len(np.unique(eval_data.users))


def _check_supported(config, model):
    unsupported = {
        "resume_checkpoint_path": ("checkpoint files", "A12"),
        "profile_steps": ("profiling", "A12"),
    }
    for key, (what, item) in unsupported.items():
        if config[key]:
            raise NotImplementedError(f"{key}: {what} is not ported yet (ROADMAP.md {item})")
    resolve_compute_dtype(config)  # an unknown type raises here
    mode = (config["phase_optimizer"] or "single").lower()
    if mode not in ("single", "per_phase", "sparse"):
        raise ValueError(
            f"phase_optimizer must be 'single', 'per_phase' or 'sparse', "
            f"got {config['phase_optimizer']!r}"
        )
    if config["mesh_shape"] and not model.MESH_READY:
        raise NotImplementedError(f"mesh_shape: model {type(model).__name__} under the mesh "
                                  "is not ported yet (ROADMAP.md A13 remainder)")


class CrossDomainTrainer:
    """Iterates ``train_modes``; per phase resets early-stopping state, flips
    the dataloader mode + model phase, and runs the epoch loop."""

    def __init__(self, config, model):
        _check_supported(config, model)
        self.config = config
        self.device = resolve_device(config)
        self.logger = getLogger()
        #: the (data, model) mesh, tables padded and row-sharded on it (JAX
        #: ``trainer.py:441-458``), or None
        self.mesh = None
        if config["mesh_shape"]:
            self.mesh = make_mesh(config["mesh_shape"], self.device)
            shard_params(model, self.mesh)
            self.logger.info(f"training over mesh {self.mesh.shape}")
        self.model = model.to(self.device)

        self.train_modes = config["train_modes"]
        self.train_epochs = config["epoch_num"]
        self.split_valid_flag = config["source_split"]

        self.valid_metric = (config["valid_metric"] or "MRR@10").lower()
        self.valid_metric_bigger = config["valid_metric_bigger"]
        self.stopping_step = config["stopping_step"]
        self.loss_decimal_place = config["loss_decimal_place"] or 4
        clip = config["clip_grad_norm"]
        self.clip = float(clip.get("max_norm", 5.0)) if clip else None

        self.evaluator = FullSortEvaluator(config)
        self.value_evaluator = ValueEvaluator(config)
        #: mixed precision: float32 master parameters, compute in this dtype
        self.compute_dtype = resolve_compute_dtype(config)
        mode = (config["phase_optimizer"] or "single").lower()
        learner = (config["learner"] or "adam").lower()
        if mode == "single" and learner in PER_PHASE_LEARNERS:
            # no shared-state form: keep the per-phase path, as the JAX
            # trainer does, so a config that trained before still trains
            self.logger.warning(
                f"phase_optimizer: 'single' supports adam/sgd, got '{learner}' — use "
                "phase_optimizer: 'per_phase'; falling back to per_phase")
            mode = "per_phase"
        self.per_phase = mode == "per_phase"
        if mode == "sparse" or (mode == "single" and learner == "sparse_adam"):
            self.optimizer = SparseAdam(config, self.model)
        else:
            self.optimizer = build_optimizer(config, self.model.parameters())
        #: every device random draw of training comes from this source
        self.random_source = TorchRandomSource(config["seed"] or 2022, self.device)

        self.best_valid_score = None
        self.best_valid_result = None
        self.best_params = None
        self.train_loss_dict = {}
        #: one record per epoch: phase, epoch, loss, seconds, examples and,
        #: where the epoch was validated, the validation's seconds and users
        self.history = []
        self._loops = {}

        # optional Weights & Biases logging (JAX trainer.py:495-505); one run
        # per job, so under a process group only the coordinator logs
        self._wandb = None
        if config["log_wandb"] and is_coordinator():
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=config["wandb_project"] or "recbole_cdr_tpu",
                           config=dict(config.final_config_dict))
            except Exception as e:  # wandb is optional
                self.logger.warning(f"wandb logging disabled: {e}")

    # ---------------------------------------------------------------- phases

    def _reinit(self, phase_idx):
        self.best_valid_score = -np.inf if self.valid_metric_bigger else np.inf
        self.best_valid_result = None
        self.train_loss_dict = {}
        self.epochs = int(self.train_epochs[phase_idx])
        self.eval_step = min(self.config["eval_step"], self.epochs)
        self.cur_step = 0

    def _snapshot(self):
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def fit(self, train_data, valid_data=None, verbose=True, saved=True,
            show_progress=False, callback_fn=None):
        for phase_idx, scheme in enumerate(self.train_modes):
            self._reinit(phase_idx)
            if verbose:
                self.logger.info(f"Start training with {scheme} mode")
            train_data.set_mode(train_mode2state[scheme])
            self.model.set_phase(scheme)
            self.model.mutate_params_on_phase(scheme)
            if self.per_phase and phase_idx > 0:
                self.optimizer = build_optimizer(self.config, self.model.parameters())
            if self._use_device_loop(scheme):
                loop = self._loop_for(scheme, train_data)
                run_epoch = lambda epoch: (loop.run_epoch(epoch),
                                           loop.examples_per_step * loop.steps_per_epoch)
            else:
                run_epoch = functools.partial(self._host_epoch, scheme, train_data,
                                              self._step_fn_for(scheme))
            self._fit_phase(scheme, run_epoch, self._route_valid(scheme, valid_data),
                            verbose, saved)
        self.model.set_phase("OVERLAP")
        return self.best_valid_score, self.best_valid_result

    def _route_valid(self, scheme, valid_data):
        if self.split_valid_flag and valid_data is not None and isinstance(valid_data, tuple):
            source_valid, target_valid = valid_data
            return source_valid if scheme == "SOURCE" else target_valid
        return valid_data

    def _use_device_loop(self, scheme) -> bool:
        """The JAX trainer's routing rule (``_use_device_loop``)."""
        return bool(
            self.config["device_side_sampling"]
            and self.config["train_neg_sample_args"]["distribution"]
            in ("uniform", "popularity", "none")
            and not self.model.needs_host_augment(scheme)
        )

    def _step_fn_for(self, scheme):
        """The phase's step function, bound to the current optimizer and to
        the model's loss for the phase as it stands now (DCDCSR's second
        TARGET phase has another loss than its first)."""
        pred = self.model.trainable_predicate(scheme)
        if isinstance(self.optimizer, SparseAdam):
            spec = self.model.sparse_spec(scheme)
            if not (spec and all(pred(name) for name in spec)):
                self.logger.warning(
                    f"phase_optimizer 'sparse': {type(self.model).__name__} declares no "
                    f"sparse_spec for phase {scheme} — falling back to the dense update "
                    "for this phase"
                )
                spec = {}
            return make_sparse_train_step(self.model, self.optimizer, scheme, spec, pred,
                                          self.compute_dtype)
        loss_fn = with_compute_dtype(phase_loss(self.model, scheme), self.compute_dtype,
                                     self.model)
        return make_train_step(self.model, self.optimizer, loss_fn, pred, self.clip, self.mesh)

    def _loop_for(self, scheme, train_data):
        """The phase's epoch loop (its device data is built once per phase
        name), with a step function bound anew on every phase entry."""
        if scheme not in self._loops:
            neg_args = self.config["train_neg_sample_args"]
            neg_num = neg_args.get("by", 0) if neg_args["strategy"] == "by" else 0
            self._loops[scheme] = DeviceEpochLoop(
                train_mode2state[scheme], None, train_data,
                self.config["MODEL_INPUT_TYPE"], neg_num,
                self.model.total_num_users, self.random_source, self.device, self.mesh,
            )
        loop = self._loops[scheme]
        loop.step_fn = self._step_fn_for(scheme)
        return loop

    def _device_batch(self, batch):
        """A host batch on the trainer's device: integer fields as int32 (the
        device loop's id type), the rest as float32; under the mesh each
        per-example field is this rank's ``data`` slice of the global batch
        (JAX ``_device_batch``, ``trainer.py:602-619``)."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            v = v.astype(np.int32 if v.dtype.kind in "iu" else np.float32)
            if self.mesh is None:
                out[k] = torch.as_tensor(v, device=self.device)
            elif v.ndim == 1:
                out[k] = put_sharded(v, self.mesh)
            else:
                out[k] = put_replicated(v, self.mesh)
        return out

    def _host_epoch(self, scheme, train_data, step_fn, epoch):
        """One epoch of the host batch path: every batch of the loader through
        ``model.augment_batch``, to the device, one optimizer step. Returns
        (summed loss as a device scalar, examples: the batches' weighted
        slots)."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        examples = 0
        for i, batch in enumerate(train_data):
            batch = self.model.augment_batch(batch, scheme)
            examples += sum(len(v) for k, v in batch.items() if k.endswith("sample_weight"))
            rng = functools.partial(self.random_source.dropout_bits, epoch, i)
            total = total + step_fn(self._device_batch(batch), rng)
        return total, examples

    def _fit_phase(self, scheme, run_epoch, valid_data, verbose, saved):
        """The phase's epochs, ``run_epoch(epoch) -> (loss, examples)`` each,
        with validation every ``eval_step`` epochs and early stopping."""
        self.model.train()
        for epoch_idx in range(self.epochs):
            t0 = time.perf_counter()
            epoch_loss, examples = run_epoch(epoch_idx)
            epoch_loss = float(epoch_loss)  # synchronizes
            dt = time.perf_counter() - t0
            self.train_loss_dict[epoch_idx] = epoch_loss
            record = {"phase": scheme, "epoch": epoch_idx, "loss": epoch_loss,
                      "train_seconds": dt, "train_examples": examples}
            self.history.append(record)
            if self._wandb is not None:
                self._wandb.log({f"train/{scheme}_loss": epoch_loss, "epoch": epoch_idx})
            if verbose:
                self.logger.info(
                    set_color(f"epoch {epoch_idx} training", "green")
                    + f" [time: {dt:.2f}s, "
                    + f"train loss: {epoch_loss:.{self.loss_decimal_place}f}]"
                )
            if not (valid_data is not None and self.eval_step
                    and (epoch_idx + 1) % self.eval_step == 0):
                continue
            t0 = time.perf_counter()
            valid_result = self._evaluate_batches(scheme, valid_data)
            record["valid_seconds"] = time.perf_counter() - t0
            record["valid_users"] = eval_users(valid_data)
            if self.device.type == "cuda":
                # the process's peak so far (never reset here): an upper
                # bound of the pass's own peak, equal to it when the pass
                # set a new one
                record["valid_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
            valid_score = valid_result.get(self.valid_metric, 0.0)
            if verbose:
                self.logger.info(set_color("valid result", "blue") + f": {valid_result}")
            if self._wandb is not None:
                self._wandb.log({f"valid/{k}": v for k, v in valid_result.items()})
            improved = (
                valid_score > self.best_valid_score
                if self.valid_metric_bigger
                else valid_score < self.best_valid_score
            )
            if improved:
                self.best_valid_score = valid_score
                self.best_valid_result = valid_result
                self.cur_step = 0
                self.best_params = self._snapshot()
            else:
                self.cur_step += 1
                if self.stopping_step is not None and self.cur_step > self.stopping_step:
                    if verbose:
                        self.logger.info("Finished training, best eval result in epoch "
                                         f"{epoch_idx - self.cur_step * self.eval_step}")
                    break
        if valid_data is None and saved:
            self.best_params = self._snapshot()

    # ------------------------------------------------------------ validation

    def _score_fn_for(self, scheme, eval_data):
        """The model's full-sort form for the phase, else the predict
        fallback (the JAX trainer's ``_score_fn_for``)."""
        fs = with_compute_dtype(self.model.full_sort_fn(scheme), self.compute_dtype, self.model)
        if fs is not None:
            return fs
        return make_predict_full_sort(self.model, eval_data.item_num, self.compute_dtype)

    def _evaluate_batches(self, scheme, eval_data):
        """Labeled and candidate eval sets to their evaluators; full-sort sets
        to the streaming top-k for large item spaces when the model factors,
        the dense path otherwise (the JAX trainer's routing)."""
        threshold = int(self.config["streaming_topk_threshold"] or 32768)
        factors = with_compute_dtype(self.model.full_sort_factors(scheme), self.compute_dtype,
                                     self.model)
        predict = with_compute_dtype(self.model.predict, self.compute_dtype, self.model)
        keys = (self.model.TARGET_USER_ID, self.model.TARGET_ITEM_ID)
        self.model.eval()
        try:
            if getattr(eval_data, "is_labeled", False):
                return self.value_evaluator.evaluate(predict, eval_data, self.device, *keys)
            if getattr(eval_data, "is_candidate", False):
                return self.evaluator.evaluate_candidates(predict, eval_data, self.device,
                                                          *keys)
            if (factors is not None and eval_data.item_num >= threshold
                    and not self.evaluator.need_gauc):
                return self.evaluator.evaluate_streaming(factors, eval_data, self.device,
                                                         mesh=self.mesh)
            return self.evaluator.evaluate(self._score_fn_for(scheme, eval_data), eval_data,
                                           self.device)
        finally:
            self.model.train()

    # -------------------------------------------------------------- evaluate

    def evaluate(self, eval_data, load_best_model=True, model_file=None, show_progress=False):
        if model_file is not None:
            raise NotImplementedError("checkpoint files are not ported yet (ROADMAP.md A12)")
        if load_best_model and self.best_params is not None:
            self.model.load_state_dict(self.best_params)
        # fit() already left the model in its final 'OVERLAP' scoring state
        if self.model.phase != "OVERLAP":
            self.model.set_phase("OVERLAP")
        return self._evaluate_batches("OVERLAP", eval_data)


class DCDCSRTrainer(CrossDomainTrainer):
    """DCDCSR's variant: no validation during the BOTH (mapping) phase
    (``recbole_cdr_tpu/trainer/trainer.py:1068-1075``, reference
    `trainer/trainer.py:124-125`)."""

    def _route_valid(self, scheme, valid_data):
        if scheme == "BOTH":
            return None
        return super()._route_valid(scheme, valid_data)
