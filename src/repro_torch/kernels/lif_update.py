"""Fused LIF membrane update: CUDA launchers and plain versions.

One kernel (``csrc/lif_update.cu``) in two forms: :func:`lif_update_cuda`,
the single clock edge of the Pallas ``lif_update``, and
:func:`lif_scan_cuda`, the whole ``[B, T, n]`` rollout in one launch with
``v`` carried in a register — what the engine runs per layer.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.lif import LIFParams, lif_rollout, lif_step
from repro_torch.kernels import _build


def lif_update_plain(v: torch.Tensor, current: torch.Tensor, beta: float,
                     threshold: float, v_reset: float):
    """``(v_next, spikes)`` of one LIF step, in float32 with ``beta * v``
    and ``+ I`` rounded separately (the oracle's arithmetic)."""
    return lif_step(v, current, LIFParams(beta=beta, threshold=threshold,
                                          v_reset=v_reset))


def lif_scan_plain(currents: torch.Tensor, lif: LIFParams) -> torch.Tensor:
    """Spikes ``[B, T, n]`` of LIF over ``currents[B, T, n]`` from v = 0."""
    spikes, _ = lif_rollout(currents.transpose(0, 1), lif)
    return spikes.transpose(0, 1).contiguous()


def _check(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} on {x.device}: the kernel needs CUDA")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32, got {x.dtype}")


def _launch(cur, v0, v_out, spikes, n_batch, n_steps, n, beta, threshold,
            v_reset) -> None:
    lib = _build.library("lif_update")
    err = lib.lif_scan_f32(
        cur.data_ptr(), None if v0 is None else v0.data_ptr(),
        None if v_out is None else v_out.data_ptr(), spikes.data_ptr(),
        n_batch, n_steps, n, float(np.float32(beta)),
        float(np.float32(threshold)), float(np.float32(v_reset)),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.launches["lif_update"] += 1
    _build.check(lib, err, "lif_update")


def lif_update_cuda(v: torch.Tensor, current: torch.Tensor, *, beta: float,
                    threshold: float, v_reset: float):
    """One LIF step on the card: v, current f32 [B, N] -> (v_next, spikes)."""
    _check(v, "v")
    _check(current, "current")
    if v.shape != current.shape or v.dim() != 2 or v.device != current.device:
        raise ValueError(f"v {tuple(v.shape)} and current "
                         f"{tuple(current.shape)} must be one [B, N] shape "
                         f"on one device")
    v_next, spikes = torch.empty_like(v), torch.empty_like(v)
    if v.numel():
        _launch(current, v, v_next, spikes, v.shape[0], 1, v.shape[1], beta,
                threshold, v_reset)
    return v_next, spikes


def lif_scan_cuda(currents: torch.Tensor, lif: LIFParams) -> torch.Tensor:
    """LIF over ``currents[B, T, n]`` from v = 0 on the card, one launch:
    returns spikes f32 [B, T, n]."""
    _check(currents, "currents")
    if currents.dim() != 3:
        raise ValueError(f"currents must be [B, T, n], got "
                         f"{tuple(currents.shape)}")
    b, t, n = currents.shape
    spikes = torch.empty_like(currents)
    if currents.numel():
        _launch(currents, None, None, spikes, b, t, n, lif.beta,
                lif.threshold, lif.v_reset)
    return spikes
