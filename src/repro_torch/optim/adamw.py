"""AdamW with decoupled weight decay + global-norm clipping.

Pure-pytree implementation over the port's parameter trees (dicts, lists
and tuples of tensors, :mod:`repro_torch.core.pytree`).  It keeps the
reference's float32 order of operations: the bias corrections are
``1 - b**t`` with ``t`` the step count in float32, ``global_norm`` sums the
leaves' squared sums with Python's ``sum`` in leaf order, and every
division is by a tensor (a true division on the card as on the CPU:
PyTorch's CUDA division by a Python number multiplies by its reciprocal).
Nothing is read back to the host: the clip scale is a device
``torch.minimum``, and ``lr`` may be a 0-d device tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params):
    """Zero moments shaped like ``params`` and an int32 step count of 0 on
    the parameters' device."""
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor, base_lr=None):
    t = step.to(torch.float32)
    warm = torch.minimum(t / t.new_full((), max(cfg.warmup_steps, 1)),
                         t.new_ones(()))
    return (cfg.lr if base_lr is None else base_lr) * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params, opt_state, grads, *, lr=None):
    """Returns (new_params, new_opt_state, metrics); new tensors throughout,
    the inputs are not written.

    ``lr``, when given, is a *dynamic* scalar (a 0-d tensor or a number)
    overriding ``cfg.lr`` as the schedule's base rate (the warmup ramp
    still applies), so an external LR schedule feeds a new rate every step
    through the same step object.
    """
    gnorm = global_norm(grads)
    scale = torch.minimum(
        gnorm.new_ones(()),
        gnorm.new_full((), cfg.grad_clip) / torch.clamp(gnorm, min=1e-12))
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step, lr)
    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda a, g: b1 * a + (1 - b1) * g, opt_state["m"], grads)
    v = tree_map(lambda a, g: b2 * a + (1 - b2) * g * g, opt_state["v"],
                 grads)
    t = step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, mm, vv):
        mhat = mm / bc1
        vhat = vv / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        return (p - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, {
        "grad_norm": gnorm, "lr": lr}
