"""Leaky integrate-and-fire neuron dynamics (paper §III-A, eq. (1)).

The A-NEURON emulates discrete-time LIF clocked by the system clock in the
per-step capacitive-discharge form ``V[t+1] = beta * V[t] + I[t]``; it fires
``S[t] = 1[V[t] >= theta]`` and hard-resets to ``V_reset``.

Forward only: the surrogate-gradient spike function arrives with training.
Every step runs in float32 with ``beta * v`` and ``+ I`` rounded separately,
which is how the float32 reference and the numpy oracle compute it.
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
    """``(beta, threshold, v_reset)`` as float32 scalars on ``device``."""
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (p.beta, p.threshold, p.v_reset))


def lif_step(v: torch.Tensor, current: torch.Tensor, p: LIFParams):
    """One clock edge of the A-NEURON: integrate, fire, reset.
    Returns ``(v_next, spikes)``."""
    beta, threshold, v_reset = lif_constants(p, v.device)
    v_integrated = beta * v + current
    fired = v_integrated >= threshold
    v_next = torch.where(fired, v_reset, v_integrated)
    return v_next, fired.to(v.dtype)


def lif_rollout(currents: torch.Tensor, p: LIFParams,
                v0: torch.Tensor | None = None):
    """Run LIF over a time-major current sequence ``currents[T, ...]``.
    Returns ``(spikes[T, ...], v_trace[T, ...])``."""
    if currents.shape[0] == 0:
        return torch.zeros_like(currents), torch.zeros_like(currents)
    v = torch.zeros_like(currents[0]) if v0 is None else v0
    spikes, vtrace = [], []
    for t in range(currents.shape[0]):
        v, s = lif_step(v, currents[t], p)
        spikes.append(s)
        vtrace.append(v)
    return torch.stack(spikes), torch.stack(vtrace)
