"""Event-driven synaptic accumulation: CUDA launchers, plain versions and
the MEM_E writer.

``event_synapse_cuda`` / ``event_synapse_packed_cuda`` launch the
hand-written kernels of ``csrc/event_synapse.cu`` (the Hopper replacement of
the Pallas ``event_synapse`` / ``event_synapse_packed``).  The ``*_plain``
functions compute the same thing in PyTorch, in the same order: the CPU path
and the yardstick the kernels are held to on the card.

Contract of an event list ``events[R, E]`` (int32): each row holds source
indices in ascending order, then ``-1`` padding — the layout
:func:`events_from_spikes` writes.  A row's sum stops at its first ``-1``;
padding only ever adds ``+0.0``, so for a compacted list that equals the
masked sum over every valid entry.  The kernel (one streaming kernel for
f32 tiles and packed codes) also relies on the ascending order: it streams
the weight tile through shared memory in ascending source chunks and adds
each row's events chunk by chunk, which is list order only because the
list is ascending.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import check_bits, lanes_per_byte, unpack_signmag
from repro_torch.kernels import _build


def _leading_valid(events: torch.Tensor) -> torch.Tensor:
    """bool [R, E]: True up to each row's first -1."""
    return (events >= 0).to(torch.int32).cumprod(dim=1).bool()


def event_synapse_plain(events: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of weights[events[r, e]]`` over the row's leading valid
    events, one float32 add per event in ascending ``e`` — the oracle's
    accumulation order, so the sums match it bit for bit."""
    r, n_events = events.shape
    out = torch.zeros(r, weights.shape[1], dtype=torch.float32,
                      device=weights.device)
    if r == 0 or n_events == 0:
        return out
    valid = _leading_valid(events)
    depth = int(valid.sum(dim=1).max())
    for e in range(depth):
        rows = weights[events[:, e].clamp(min=0).long()]
        out = torch.where(valid[:, e, None], out + rows, out)
    return out


def dequantize_packed(packed_w: torch.Tensor, scale,
                      bits: int) -> torch.Tensor:
    """Packed sign-magnitude codes -> float32 ``fl32(q * scale)`` tile."""
    q = unpack_signmag(packed_w, check_bits(bits)).to(torch.float32)
    return q * torch.as_tensor(scale, dtype=torch.float32,
                               device=q.device).reshape(())


def event_synapse_packed_plain(events: torch.Tensor, packed_w: torch.Tensor,
                               scale, bits: int) -> torch.Tensor:
    """Plain packed-operand accumulation: dequantize every code to
    ``fl32(q * scale)``, then the dense plain sum — bit-exact with
    :func:`event_synapse_plain` on the dequantized tile."""
    return event_synapse_plain(events, dequantize_packed(packed_w, scale, bits))


def _check_events(events: torch.Tensor) -> None:
    if not events.is_cuda:
        raise ValueError(f"events on {events.device}: the kernel needs CUDA")
    if events.dtype != torch.int32 or events.dim() != 2:
        raise ValueError(f"events must be int32 [R, E], got "
                         f"{events.dtype} {tuple(events.shape)}")
    if events.shape[1] > 1 and events.stride(1) != 1:
        raise ValueError("events rows must be contiguous")


def _check_weights(w: torch.Tensor, events: torch.Tensor, dtype) -> None:
    if w.device != events.device:
        raise ValueError(f"weights on {w.device}, events on {events.device}")
    if w.dtype != dtype or w.dim() != 2:
        raise ValueError(f"weights must be {dtype} 2-D, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.shape[1] > 1 and w.stride(1) != 1:
        raise ValueError("weight rows must be contiguous")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def event_synapse_cuda(events: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Launch the dense kernel: events i32 [R, E] (each row's valid sources
    ascending, as :func:`events_from_spikes` writes them), weights f32
    [n_src, n_dest] on one CUDA device -> currents f32 [R, n_dest]."""
    _check_events(events)
    _check_weights(weights, events, torch.float32)
    r, n_events = events.shape
    n_dest = weights.shape[1]
    out = torch.empty(r, n_dest, dtype=torch.float32, device=events.device)
    if r == 0 or n_events == 0 or n_dest == 0:
        return out.zero_()
    lib = _build.library("event_synapse")
    err = lib.event_synapse_f32(events.data_ptr(), events.stride(0),
                                weights.data_ptr(), weights.stride(0),
                                out.data_ptr(), r, n_events, n_dest, _stream())
    _build.launches["event_synapse"] += 1
    _build.check(lib, err, "event_synapse")
    return out


def event_synapse_packed_cuda(events: torch.Tensor, packed_w: torch.Tensor,
                              scale, bits: int) -> torch.Tensor:
    """Launch the packed kernel: events i32 [R, E], packed_w i8
    [n_src, n_dest * bits / 8] (quant.pack_signmag lanes), scale the f32
    layer scale -> currents f32 [R, n_dest]."""
    _check_events(events)
    _check_weights(packed_w, events, torch.int8)
    r, n_events = events.shape
    n_dest = packed_w.shape[1] * lanes_per_byte(bits)
    out = torch.empty(r, n_dest, dtype=torch.float32, device=events.device)
    if r == 0 or n_events == 0 or n_dest == 0:
        return out.zero_()
    scale_f = float(torch.as_tensor(scale, dtype=torch.float32).reshape(()))
    lib = _build.library("event_synapse")
    err = lib.event_synapse_packed_i8(
        events.data_ptr(), events.stride(0), packed_w.data_ptr(),
        packed_w.stride(0), scale_f, bits, out.data_ptr(), r, n_events,
        n_dest, _stream())
    _build.launches["event_synapse_packed"] += 1
    _build.check(lib, err, "event_synapse_packed")
    return out


def events_from_spikes(spikes: torch.Tensor, max_events: int) -> torch.Tensor:
    """Dense spike rows ``[B, n_src]`` -> padded event lists
    ``[B, min(max_events, n_src)]`` (int32, pad -1): the software MEM_E
    writer.  Events beyond ``max_events`` are dropped (see
    :func:`overflow_count`).

    Stable O(n) compaction: a spiking source's slot is its exclusive prefix
    count along the row, so events come out in ascending source order (the
    hardware FIFO write order and the oracle's accumulation order).
    Non-spiking and overflowing sources scatter into a trash slot that is
    sliced off.  The result is a view whose rows are contiguous.
    """
    b, n = spikes.shape
    max_events = min(int(max_events), n)
    spk = spikes > 0
    pos = torch.cumsum(spk, dim=1, dtype=torch.int32) - 1
    pos = torch.where(spk & (pos < max_events), pos, max_events)
    idx = torch.arange(n, dtype=torch.int32, device=spikes.device)
    out = torch.full((b, max_events + 1), -1, dtype=torch.int32,
                     device=spikes.device)
    out.scatter_(1, pos.long(), idx.expand(b, n))
    return out[:, :max_events]


def overflow_count(spikes: torch.Tensor, max_events: int) -> torch.Tensor:
    """How many events per row the static MEM_E depth dropped."""
    n_spk = (spikes > 0).sum(dim=1)
    return (n_spk - max_events).clamp(min=0)
