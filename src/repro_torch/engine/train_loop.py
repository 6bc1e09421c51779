"""Training loop: fault tolerance, straggler detection, gradient compression.

  * **checkpoint/restart** — async atomic checkpoints every
    ``checkpoint_every`` steps (:mod:`repro_torch.checkpoint.manager`); on
    (re)start the loop resumes from the latest valid step.  The data
    pipeline is step-keyed, so restart is exactly-once with no reader
    state.
  * **preemption** — a ``failure_hook`` (tests inject one) may raise at any
    step boundary; the last committed checkpoint stays consistent (atomic
    rename) and restart continues the same trajectory (bit-exact when the
    step is deterministic).
  * **straggler detection** — steps slower than ``straggler_factor`` x the
    trailing median are counted and logged.

A step is a plain function ``(state_tree, batch) -> (state_tree,
metrics)`` that builds new tensors; the loop reads each step's scalar
metrics back to the host in one transfer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_checkpoint)
from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import (CompressionConfig, compress_gradients,
                                        decompress_gradients, init_residual)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    residual: Any | None = None   # error-feedback state (compression)

    def as_tree(self):
        t = {"params": self.params, "opt": self.opt}
        if self.residual is not None:
            t["residual"] = self.residual
        return t

    @staticmethod
    def from_tree(t):
        return TrainState(params=t["params"], opt=t["opt"],
                          residual=t.get("residual"))


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None     # None: no checkpoints
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_checkpoints: int = 3


def init_train_state(bundle_or_loss, params, opt_cfg: AdamWConfig,
                     comp_cfg: CompressionConfig | None = None) -> TrainState:
    return TrainState(
        params=params,
        opt=adamw_init(params),
        residual=init_residual(params) if (comp_cfg and comp_cfg.enabled)
        else None)


def _value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params``, taken on fresh leaves (the caller's tensors are
    neither marked nor written)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    comp_cfg: CompressionConfig | None = None,
                    microbatches: int = 1):
    """Builds the train step: grad -> (compress->decompress with error
    feedback) -> AdamW.

    ``microbatches > 1`` accumulates gradients: the batch is split along
    axis 0 and the microbatches run in order, their losses and gradients
    summed from zero and scaled by ``1 / microbatches`` — the mean over
    microbatches, as the reference's scan computes it.
    """

    def grad_fn(params, batch):
        if microbatches <= 1:
            return _value_and_grad(loss_fn, params, batch)
        split = tree_map(
            lambda a: a.reshape(microbatches, a.shape[0] // microbatches,
                                *a.shape[1:]), batch)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(microbatches):
            l, g = _value_and_grad(loss_fn, params,
                                   tree_map(lambda a: a[i], split))
            loss = loss + l
            grads = tree_map(torch.add, grads, g)
        inv = 1.0 / microbatches
        return loss * inv, tree_map(lambda g: g * inv, grads)

    def step(state: dict, batch: dict):
        loss, grads = grad_fn(state["params"], batch)
        residual = state.get("residual")
        if comp_cfg and comp_cfg.enabled:
            comp, residual = compress_gradients(grads, residual, comp_cfg)
            grads = decompress_gradients(comp, grads)
        params, opt, metrics = adamw_update(opt_cfg, state["params"],
                                            state["opt"], grads)
        new_state = {"params": params, "opt": opt}
        if residual is not None:
            new_state["residual"] = residual
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return step


def _scalar_metrics(metrics: dict) -> dict[str, float]:
    """Every 0-d metric as a Python float; the tensors come back to the
    host in one transfer (a float64 stack, exact for float32 and int32)."""
    keys = [k for k, v in metrics.items() if getattr(v, "ndim", 0) == 0]
    tensors = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(metrics[k]) for k in keys if k not in tensors}
    if tensors:
        stacked = torch.stack([metrics[k].detach().to(torch.float64)
                               for k in tensors]).tolist()
        out.update(zip(tensors, stacked))
    return out


def train_loop(state_tree: dict, step_fn, batch_fn, cfg: TrainLoopConfig,
               start_step: int = 0,
               failure_hook: Callable[[int], None] | None = None,
               log_fn: Callable[[str], None] = print):
    """Run the loop.  ``step_fn(state, batch)`` is the train step,
    ``batch_fn(step)`` produces the step's batch (step-keyed, restart-safe).

    Returns (final state, history dict).
    """
    mgr = (CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
           if cfg.checkpoint_dir else None)   # None: ephemeral, no ckpt I/O
    history = {"loss": [], "step_time": [], "stragglers": 0,
               "checkpoints": []}
    durations: list[float] = []
    step = start_step
    try:
        while step < cfg.steps:
            if failure_hook is not None:
                failure_hook(step)
            t0 = time.monotonic()
            batch = batch_fn(step)
            state_tree, metrics = step_fn(state_tree, batch)
            scalars = _scalar_metrics(metrics)     # waits for the step
            loss = scalars.pop("loss")
            dt = time.monotonic() - t0
            durations.append(dt)
            med = sorted(durations[-32:])[len(durations[-32:]) // 2]
            if len(durations) > 4 and dt > cfg.straggler_factor * med:
                history["stragglers"] += 1
                log_fn(f"[straggler] step {step}: {dt*1e3:.1f}ms vs "
                       f"median {med*1e3:.1f}ms")
            history["loss"].append(loss)
            history["step_time"].append(dt)
            for k, v in scalars.items():
                # any extra scalar metric (acc, grad_norm, lr, ...)
                history.setdefault(k, []).append(v)
            step += 1
            if mgr is not None and (step % cfg.checkpoint_every == 0
                                    or step == cfg.steps):
                mgr.save_async(step, state_tree, extra={"loss": loss})
                history["checkpoints"].append(step)
            if step % cfg.log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} "
                       f"({dt*1e3:.0f} ms/step)")
    finally:
        if mgr is not None:
            mgr.wait()
    return state_tree, history


def resume_or_init(cfg: TrainLoopConfig, init_state_tree: dict,
                   device="cuda") -> tuple[dict, int]:
    """Restore the latest checkpoint onto ``device`` if there is one.  A
    mesh-trained step keeps its state on the mesh's first device, which is
    the ``device`` to pass.  Checkpoints do not record the mesh, so a run
    checkpointed on one mesh resumes on a mesh of any size (elastic
    restart)."""
    last = latest_step(cfg.checkpoint_dir)
    if last is None:
        return init_state_tree, 0
    state = restore_checkpoint(cfg.checkpoint_dir, last, init_state_tree,
                               device)
    return state, last
