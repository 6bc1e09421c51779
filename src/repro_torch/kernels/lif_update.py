"""Fused LIF membrane update: CUDA launchers and plain versions.

One kernel (``csrc/lif_update.cu``) in two forms: :func:`lif_update_cuda`,
the single clock edge of the Pallas ``lif_update``, and
:func:`lif_scan_cuda`, the whole ``[B, T, n]`` rollout in one launch with
``v`` carried in a register — what the engine runs per layer.  A block owns
one sample and a tile of 32, 64 or 128 neurons (:func:`tile_cols`), so that
the grid fills the card; the launch path keeps its library entry and the
LIF constants as float32 once, and reads nothing from the device.  Each
launch runs with the currents' device made current and on its current
stream; the kernel's shared-memory ceiling is set once per device.
"""

from __future__ import annotations

import ctypes
import functools

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


TILE_COLS = (128, 64, 32)   # neurons a block may own, widest first
FILL = 7 / 8                # share of the SMs a tile's grid must cover


def tile_cols(n_batch: int, n: int, n_sms: int) -> int:
    """The neurons a block owns: the widest tile whose grid of
    ``n_batch * ceil(n / cols)`` blocks covers at least ``FILL`` of the
    card's ``n_sms`` SMs (about one wave), else the narrowest."""
    for cols in TILE_COLS:
        if n_batch * -(-n // cols) >= FILL * n_sms:
            return cols
    return TILE_COLS[-1]


@functools.cache
def _entry():
    lib = _build.library("lif_update")
    return lib, lib.lif_scan_f32


@functools.cache
def _n_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _constants(beta: float, threshold: float, v_reset: float):
    return tuple(ctypes.c_float(np.float32(x)) for x in
                 (beta, threshold, v_reset))


def _launch(cur, v0, v_out, spikes, n_batch, n_steps, n, beta, threshold,
            v_reset) -> None:
    lib, fn = _entry()
    dev = cur.device.index
    with torch.cuda.device(dev):
        err = fn(cur.data_ptr(), None if v0 is None else v0.data_ptr(),
                 None if v_out is None else v_out.data_ptr(),
                 spikes.data_ptr(), n_batch, n_steps, n,
                 tile_cols(n_batch, n, _n_sms(dev)),
                 *_constants(beta, threshold, v_reset),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
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
