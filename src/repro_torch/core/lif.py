"""Leaky integrate-and-fire neuron dynamics (paper §III-A, eq. (1)).

The A-NEURON emulates discrete-time LIF clocked by the system clock in the
per-step capacitive-discharge form ``V[t+1] = beta * V[t] + I[t]``; it fires
``S[t] = 1[V[t] >= theta]`` and hard-resets to ``V_reset``.

Training uses a fast-sigmoid surrogate gradient (Eshraghian et al., the
paper's SNNTorch reference [31]) through :class:`SpikeFn`.  Every forward
step runs in float32 with ``beta * v`` and ``+ I`` rounded separately, which
is how the float32 reference and the numpy oracle compute it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Static LIF cell parameters (shared by a layer)."""

    beta: float = 0.9          # membrane decay per time step (capacitor discharge)
    threshold: float = 1.0     # V_th
    v_reset: float = 0.0       # reset potential
    surrogate_slope: float = 25.0  # fast-sigmoid slope k


def lif_constants(p: LIFParams, device) -> tuple[torch.Tensor, ...]:
    """``(beta, threshold, v_reset)`` as float32 scalars on ``device``,
    filled in place there: no host-to-device copy, so a forward that makes
    them once reads and waits on nothing."""
    return tuple(torch.full((), x, dtype=torch.float32, device=device)
                 for x in (p.beta, p.threshold, p.v_reset))


class SpikeFn(torch.autograd.Function):
    """Heaviside spike with fast-sigmoid surrogate gradient.

    forward:  S = 1[v >= threshold]
    backward: dS/dv ~ slope / (1 + |slope (v - threshold)|)^2, computed as
    the reference does, ``g * (1 / (1 + |x|)^2) * slope`` with
    ``x = slope * (v - threshold)``; no gradient for threshold or slope.
    """

    @staticmethod
    def forward(ctx, v, threshold, slope):
        ctx.save_for_backward(v)
        ctx.threshold, ctx.slope = threshold, slope
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        x = ctx.slope * (v - ctx.threshold)
        surr = 1.0 / (1.0 + x.abs()) ** 2
        return g * surr * ctx.slope, None, None


def spike_fn(v: torch.Tensor, threshold, slope) -> torch.Tensor:
    """``1[v >= threshold]`` in ``v``'s dtype, with the surrogate gradient
    of :class:`SpikeFn` (``threshold`` a number or a scalar tensor)."""
    return SpikeFn.apply(v, threshold, slope)


def lif_step(v: torch.Tensor, current: torch.Tensor, p: LIFParams,
             constants: tuple[torch.Tensor, ...] | None = None):
    """One clock edge of the A-NEURON: integrate, fire (through
    :func:`spike_fn`), reset.  Returns ``(v_next, spikes)``.

    ``constants`` is :func:`lif_constants` ``(p, v.device)``, made once by
    a caller that steps many times (a forward over T and the layers);
    without it each call makes its own."""
    beta, threshold, v_reset = (lif_constants(p, v.device)
                                if constants is None else constants)
    v_integrated = beta * v + current
    spikes = spike_fn(v_integrated, threshold, p.surrogate_slope)
    v_next = torch.where(spikes > 0, v_reset, v_integrated)
    return v_next, spikes


def lif_rollout(currents: torch.Tensor, p: LIFParams,
                v0: torch.Tensor | None = None):
    """Run LIF over a time-major current sequence ``currents[T, ...]``.
    Returns ``(spikes[T, ...], v_trace[T, ...])``."""
    if currents.shape[0] == 0:
        return torch.zeros_like(currents), torch.zeros_like(currents)
    v = torch.zeros_like(currents[0]) if v0 is None else v0
    constants = lif_constants(p, currents.device)
    spikes, vtrace = [], []
    for t in range(currents.shape[0]):
        v, s = lif_step(v, currents[t], p, constants)
        spikes.append(s)
        vtrace.append(v)
    return torch.stack(spikes), torch.stack(vtrace)


def rate_encode(x: torch.Tensor, num_steps: int,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Rate-based spike encoding (the accelerator's supported encoding).

    ``x`` in [0, 1]; returns Bernoulli spike trains ``[num_steps, *x.shape]``
    (float32), frame ``t`` = ``uniform < x``, drawn from ``generator`` (on
    ``x``'s device).  Its draws follow the law, not the JAX reference's
    bits: a torch generator cannot replay a JAX key."""
    u = torch.rand((num_steps, *x.shape), generator=generator,
                   device=x.device)
    return (u < x).to(torch.float32)


def spike_count_decode(spikes: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Rate decode: spike counts over the window (used for classification).
    The counts times the float32 reciprocal of ``num_steps``, which is how
    the reference's compiled division by a constant computes it."""
    one = torch.ones((), dtype=torch.float32, device=spikes.device)
    return spikes.sum(dim=0) * (one / num_steps)
