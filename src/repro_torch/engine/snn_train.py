"""The SNN training engine of the port.

The paper's evaluation models (§IV-A) train with surrogate gradients; this
module is the one path for that training.  One entry point —
:func:`train_snn_model` — drives any :class:`SNNModel` (MLP or conv)
through the same machinery as any other model of the repository:

  * :mod:`repro_torch.engine.train_loop` — async atomic checkpoints,
    straggler detection, step-keyed restart-safe data;
  * :mod:`repro_torch.optim.adamw` — :func:`adamw_update` with the base
    learning rate passed as a 0-d device tensor in the batch, so an LR
    schedule changes the rate every step through the same step object.

Bit-exactness contract: the gradient of a step is *defined* as a
fixed-order left fold over ``grad_shards`` contiguous batch chunks of
per-chunk gradients, scaled by ``1/K`` — the reference's definition, so a
run's arithmetic does not depend on how its chunks are scheduled.  The
mesh (:func:`snn_train_mesh`, the serving mesh: an ordered tuple of
devices driven by this one process) only decides *where* chunks are
computed: shard ``s`` evaluates its contiguous chunks on its device with a
replica of the parameters, the per-chunk results are gathered onto the
mesh's first device in shard order (= global chunk order) and folded left
to right there, and Adam runs there once, the new parameters copied out to
the other devices.  Training over a mesh is therefore bit-exact with
single-device training at the same ``grad_shards`` and data order, and a
checkpoint written on an 8-way mesh resumes on a 4-way mesh onto the same
trajectory (tested, ``tests/test_torch_snn_train.py``).  ``grad_shards``
defaults to the mesh's split of the batch (1 without a mesh).  On the card
the products run with TF32 off and cuDNN's deterministic algorithms
(:func:`repro_torch.device.exact_float32`), so a run, and a run resumed
from a checkpoint, repeat bit for bit.

What the reference has and this module leaves out:

  * ``donate`` — PyTorch has no buffer donation.  The step builds new
    tensors and never writes into the caller's parameters, so there is
    nothing to copy either.
  * ``snn_train_trace_count`` — there is no trace to count: the step is a
    plain Python function, and the learning rate reaches it as a tensor
    whatever its value.

The step reads nothing back from the device; the loop reads each step's
metrics in one transfer.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import (canonical_device, device_guard, exact_float32,
                                resolve_device)
from repro_torch.engine.sharded_run import (ServeMesh, n_batch_shards,
                                            snn_serve_mesh)
from repro_torch.engine.train_loop import (TrainLoopConfig, init_train_state,
                                           resume_or_init, train_loop)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.snn import conv as _conv
from repro_torch.snn import mlp as _mlp
from repro_torch.stage_spans import span

_log = logging.getLogger(__name__)

# ------------------------------------------------------------ model protocol

@runtime_checkable
class SNNModel(Protocol):
    """What the trainer needs from a model family.

    ``spikes`` are time-major ``[T, B, n_in]``; ``loss`` returns
    ``(mean_loss, mean_accuracy)`` over the batch, differentiable through
    the surrogate-gradient LIF; ``layer_specs`` lowers trained (possibly
    pruned) params to the ``map_model`` stack.
    """

    name: str

    def init(self, generator: torch.Generator, cfg, device="cuda") -> Any: ...

    def forward(self, params, spikes: torch.Tensor, cfg): ...

    def loss(self, params, spikes: torch.Tensor, labels: torch.Tensor,
             cfg): ...

    def layer_specs(self, params, cfg) -> list: ...


class _MLPModel:
    """The paper's spiking MLPs (``snn/mlp.py``) behind the protocol."""

    name = "mlp"

    def init(self, generator, cfg: "_mlp.SNNConfig", device="cuda"):
        return _mlp.init_snn(generator, cfg, device)

    def forward(self, params, spikes, cfg: "_mlp.SNNConfig"):
        return _mlp.snn_forward(params, spikes, cfg)

    def loss(self, params, spikes, labels, cfg: "_mlp.SNNConfig"):
        return _mlp.snn_loss(params, spikes, labels, cfg)

    def layer_specs(self, params, cfg: "_mlp.SNNConfig"):
        # bare 2-D host matrices; map_model coerces them to Dense specs
        return [w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
                else np.asarray(w) for w in params]


class _ConvModel:
    """The spiking CNN family (``snn/conv.py``) behind the protocol."""

    name = "conv"

    def init(self, generator, cfg: "_conv.ConvSNNConfig", device="cuda"):
        return _conv.init_conv_snn(generator, cfg, device)

    def forward(self, params, spikes, cfg: "_conv.ConvSNNConfig"):
        return _conv.conv_snn_forward(params, spikes, cfg)

    def loss(self, params, spikes, labels, cfg: "_conv.ConvSNNConfig"):
        return _conv.conv_snn_loss(params, spikes, labels, cfg)

    def layer_specs(self, params, cfg: "_conv.ConvSNNConfig"):
        return _conv.layer_specs(params, cfg)


MLP_MODEL: SNNModel = _MLPModel()
CONV_MODEL: SNNModel = _ConvModel()


def model_for(cfg) -> SNNModel:
    """The model family matching a config dataclass."""
    if isinstance(cfg, _conv.ConvSNNConfig):
        return CONV_MODEL
    if isinstance(cfg, _mlp.SNNConfig):
        return MLP_MODEL
    raise TypeError(f"no SNN model family for config {type(cfg).__name__}")


# ------------------------------------------------------------- configuration

@dataclasses.dataclass(frozen=True)
class SNNTrainConfig:
    """Hyperparameters and loop knobs for :func:`train_snn_model`.

    The defaults are the paper's Table-I Adam (lr=1e-3, b2=0.999, no weight
    decay, no clipping, constant rate).  ``lr`` may be a schedule
    ``step -> rate``; it reaches the step as a 0-d tensor in the batch.
    ``grad_shards`` fixes the gradient's chunked fold (module docstring;
    ``None``: the mesh's split of the batch, 1 without a mesh); ``mesh``
    spreads the chunks over its devices.  ``checkpoint_dir`` ``None``
    trains ephemerally (no checkpoint I/O); a path makes training
    resume-aware across restarts and mesh sizes.
    """

    steps: int = 100
    lr: "float | Callable[[int], float]" = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = math.inf
    warmup_steps: int = 1
    mesh: ServeMesh | None = None
    grad_shards: int | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 50
    straggler_factor: float = 3.0

    def adamw(self) -> AdamWConfig:
        base = self.lr if not callable(self.lr) else self.lr(0)
        return AdamWConfig(lr=float(base), b1=self.b1, b2=self.b2,
                           eps=self.eps, weight_decay=self.weight_decay,
                           grad_clip=self.grad_clip,
                           warmup_steps=self.warmup_steps)


def snn_train_mesh(n_data: int | None = None, **kw) -> ServeMesh:
    """The training mesh: literally the serving topology
    (:func:`repro_torch.engine.sharded_run.snn_serve_mesh`, same keywords),
    so training and serving can never drift onto different meshes."""
    return snn_serve_mesh(n_data, **kw)


def _batch_split(mesh: ServeMesh, dims) -> int:
    """How many ways the training rule splits a ``[T, B, n_in]`` spike
    batch on ``mesh``: the mesh's size when it divides ``B``, else 1
    (replicated), the serving rule's graceful degradation."""
    return n_batch_shards(mesh, dims[1])


# ---------------------------------------------------------------- train step

def make_snn_train_step(model: SNNModel, cfg, opt_cfg: AdamWConfig, *,
                        mesh: ServeMesh | None = None,
                        grad_shards: int | None = None):
    """Build the step ``(state_tree, batch) -> (state_tree, metrics)`` for
    :func:`repro_torch.engine.train_loop.train_loop`.

    ``batch`` is ``{"spikes": [T, B, n_in], "labels": [B], "lr": 0-d}``
    tensors on the parameters' device (``lr`` optional — the dynamic base
    rate for :func:`adamw_update`).  The gradient is the fixed-order
    chunked fold of the module docstring: ``K = grad_shards`` contiguous
    chunks of the batch (default the mesh's split of ``B``, 1 without a
    mesh), each chunk's loss, accuracy and gradient of the model's mean
    loss, summed left to right and scaled by ``1/K``.  With a mesh that
    splits the batch ``n`` ways, shard ``s`` computes chunks ``s K/n`` to
    ``(s + 1) K/n - 1`` on ``mesh.devices[s]`` from a replica of the
    parameters (copied there once per step); ``K`` must then be a multiple
    of ``n``, else the step trains on the first device alone, with a
    warning, as it does when the batch does not split.
    """
    warned: set = set()

    def warn(key, msg, *args):
        if key not in warned:       # once per batch shape, as a trace would
            warned.add(key)
            _log.warning(msg, *args)

    def chunk(params, spikes, labels):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with exact_float32(spikes.device):
            with span("train.forward"):
                loss, acc = model.loss(tree_unflatten(params, leaves),
                                       spikes, labels, cfg)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        return [loss.detach(), acc.detach(), *grads]

    def step(state: dict, batch: dict):
        spikes, labels = batch["spikes"], batch["labels"]
        t, b, n_in = spikes.shape
        n_split = _batch_split(mesh, (t, b, n_in)) if mesh is not None else 1
        k = n_split if grad_shards is None else grad_shards
        if b % k:
            raise ValueError(
                f"batch {b} not divisible into grad_shards={k} chunks")
        # graceful fallbacks replicate instead of failing, but not
        # silently: a user who built a mesh expects data parallelism
        if k % n_split:
            warn(("k", b), "snn_train: grad_shards=%d is not a multiple of "
                 "the mesh's %d-way batch split — training replicated on "
                 "one device instead of data-parallel", k, n_split)
            n_split = 1
        elif mesh is not None and mesh.size > 1 and n_split == 1:
            warn(("b", b), "snn_train: batch %d does not split over the "
                 "%d-device mesh — training replicated on one device "
                 "instead of data-parallel", b, mesh.size)
        size = b // k
        per_shard = k // n_split
        home = canonical_device(spikes.device)
        # the parameters on each distinct device of the split, copied once
        replicas = {home: state["params"]}
        parts = []
        for s in range(n_split):
            dev = mesh.devices[s] if n_split > 1 else home
            lo = s * per_shard * size
            with device_guard(dev):
                if dev not in replicas:
                    replicas[dev] = tree_map(lambda p: p.to(dev),
                                             state["params"])
                sp = spikes[:, lo:lo + per_shard * size].to(dev)
                lb = labels[lo:lo + per_shard * size].to(dev)
                for i in range(per_shard):
                    parts.append(chunk(replicas[dev],
                                       sp[:, i * size:(i + 1) * size],
                                       lb[i * size:(i + 1) * size]))
        # gather onto the first device in shard (= chunk) order, then one
        # left fold there, exactly as the single-device fold adds
        total = None
        for part in parts:
            part = [x.to(home) for x in part]
            total = part if total is None else [
                u + v for u, v in zip(total, part)]
        inv = 1.0 / k
        loss, acc, *grads = [x * inv for x in total]
        with span("train.optimizer"):
            params, opt, metrics = adamw_update(
                opt_cfg, state["params"], state["opt"],
                tree_unflatten(state["params"], grads), lr=batch.get("lr"))
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["acc"] = acc
        return {"params": params, "opt": opt}, metrics

    return step



# --------------------------------------------------------------- entry point

def _upload(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                         dtype=dtype)


def train_snn_model(model: SNNModel, cfg, data_iter,
                    train_cfg: SNNTrainConfig, *,
                    key: torch.Generator | None = None, params=None,
                    device=None, log_fn: Callable[[str], None] = print):
    """Train an SNN family through the engine loop on ``device`` (default
    the card; ``device="cpu"`` runs the plain PyTorch path), or over
    ``train_cfg.mesh``, whose first device then holds the parameters, the
    optimizer state and the batch (``device``, if given, must name it).

    ``data_iter`` is either a step-keyed callable ``step -> (spikes
    [T, B, n_in], labels [B])`` — the restart-safe form: resuming from a
    checkpoint replays the exact remaining batches — or any iterator
    yielding such pairs (``data/events.event_batches``), which trains fine
    but cannot guarantee the same batches after a restart.  The pairs may
    be numpy arrays or tensors.  ``key`` is the generator the initial
    weights are drawn from (seed 0 when ``None``); ``params``, when given,
    is the start instead (placed on ``device`` as float32; the step never
    writes into it).

    Returns ``(params, history)``; ``history`` is the train-loop dict
    (``loss`` / ``acc`` / ``grad_norm`` / ``lr`` / ``step_time`` /
    ``stragglers`` / ``checkpoints``).
    """
    mesh = train_cfg.mesh
    if mesh is None:
        dev = resolve_device("cuda" if device is None else device)
    else:
        dev = mesh.devices[0]
        if device is not None and \
                canonical_device(resolve_device(device)) != dev:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {dev}")
    if params is None:
        gen = key if key is not None else torch.Generator().manual_seed(0)
        params = model.init(gen, cfg, dev)
    else:
        params = tree_map(lambda p: _upload(p, torch.float32, dev), params)
    opt_cfg = train_cfg.adamw()
    state = init_train_state(None, params, opt_cfg).as_tree()
    step_fn = make_snn_train_step(model, cfg, opt_cfg, mesh=mesh,
                                  grad_shards=train_cfg.grad_shards)
    if callable(data_iter):
        data = data_iter
    else:
        it = iter(data_iter)
        data = lambda step: next(it)  # noqa: E731
    lr = train_cfg.lr
    lr_of = lr if callable(lr) else (lambda step: lr)

    def batch_fn(step: int) -> dict:
        spikes, labels = data(step)
        return {"spikes": _upload(spikes, torch.float32, dev),
                "labels": _upload(labels, torch.int64, dev),
                "lr": torch.full((), float(lr_of(step)), dtype=torch.float32,
                                 device=dev)}

    loop_cfg = TrainLoopConfig(steps=train_cfg.steps,
                               checkpoint_every=train_cfg.checkpoint_every,
                               checkpoint_dir=train_cfg.checkpoint_dir,
                               log_every=train_cfg.log_every,
                               straggler_factor=train_cfg.straggler_factor,
                               keep_checkpoints=train_cfg.keep_checkpoints)
    start = 0
    if train_cfg.checkpoint_dir is not None:
        state, start = resume_or_init(loop_cfg, state, dev)
        if start:
            log_fn(f"[snn_train] resumed {model.name} from step {start} "
                   f"({train_cfg.checkpoint_dir})")
    state, history = train_loop(state, step_fn, batch_fn, loop_cfg,
                                start_step=start, log_fn=log_fn)
    return state["params"], history
