"""Kernel entry points, dispatched by the device of the tensors given.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version (``ref``).  Nothing falls
back from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.core.lif import LIFParams
from repro_torch.core.quant import check_bits
from repro_torch.kernels import c2c_matmul as _c2c
from repro_torch.kernels import event_synapse as _es
from repro_torch.kernels import lif_update as _lif
from repro_torch.kernels import ref  # noqa: F401  (re-exported for convenience)
from repro_torch.kernels.event_synapse import (events_from_spikes,  # noqa: F401
                                               overflow_count)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def event_synapse(events: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """events i32 [R, E] (pad -1), weights f32 [n_src, n_dest] ->
    currents f32 [R, n_dest]."""
    if _on_cuda(events):
        return _es.event_synapse_cuda(events, weights)
    return _es.event_synapse_plain(events, weights)


def event_synapse_packed(events: torch.Tensor, packed_w: torch.Tensor,
                         scale, *, bits: int) -> torch.Tensor:
    """Packed-operand twin of :func:`event_synapse`: packed_w i8
    [n_src, n_dest * bits / 8] sign-magnitude lanes, scale f32."""
    bits = check_bits(bits)
    if _on_cuda(events):
        return _es.event_synapse_packed_cuda(events, packed_w, scale, bits)
    return _es.event_synapse_packed_plain(events, packed_w, scale, bits)


def lif_update(v: torch.Tensor, current: torch.Tensor, *, beta: float = 0.9,
               threshold: float = 1.0, v_reset: float = 0.0):
    """One LIF step: v, current f32 [B, N] -> (v_next, spikes)."""
    if _on_cuda(v):
        return _lif.lif_update_cuda(v, current, beta=beta,
                                    threshold=threshold, v_reset=v_reset)
    return _lif.lif_update_plain(v, current, beta, threshold, v_reset)


def lif_scan(currents: torch.Tensor, lif: LIFParams) -> torch.Tensor:
    """LIF over currents f32 [B, T, n] from v = 0 -> spikes [B, T, n]."""
    if _on_cuda(currents):
        return _lif.lif_scan_cuda(currents, lif)
    return _lif.lif_scan_plain(currents, lif)


def c2c_matmul(x: torch.Tensor, w_q: torch.Tensor, scale) -> torch.Tensor:
    """The ideal C2C-ladder MAC: x f32 [M, K], w_q int8 [K, N], scale f32
    scalar -> ``(x @ w_q) * scale`` f32 [M, N]."""
    if _on_cuda(x):
        return _c2c.c2c_matmul_cuda(x, w_q, scale)
    return _c2c.c2c_matmul_plain(x, w_q, scale)


__all__ = ["event_synapse", "event_synapse_packed", "lif_update", "lif_scan",
           "c2c_matmul", "events_from_spikes", "overflow_count", "ref"]
