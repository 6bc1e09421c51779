"""Event-driven synaptic accumulation: CUDA launchers, plain versions and
the MEM_E writer.

``event_synapse_cuda`` / ``event_synapse_packed_cuda`` launch the
hand-written kernels of ``csrc/event_synapse.cu`` (the Hopper replacement of
the Pallas ``event_synapse`` / ``event_synapse_packed``).  The ``*_plain``
functions compute the same thing in PyTorch, in the same order: the CPU path
and the yardstick the kernels are held to on the card.

Contract of an event list ``events[R, E]`` (int32), as the reference's:
every entry ``>= 0`` is a source index, every ``-1`` is padding, wherever it
sits, and a row's sum adds each valid entry's weight row in list order, one
rounded float32 add each.  Skipping a padding entry equals the reference's
``acc + 0.0`` bit for bit: the sum starts at ``+0.0`` and so is never
``-0.0``.

The plain versions take every such list.  The kernel (one streaming kernel
for f32 tiles and packed codes) takes compacted, strictly ascending rows
only, the layout :func:`events_from_spikes` writes: it streams the weight
tile through shared memory in ascending source chunks, which is list order
only for an ascending list.  So the CUDA launchers first compact each row
on the device (a stable prefix-count-and-scatter that keeps list order,
turning interior ``-1`` s into trailing padding, bit-exact for the reason
above), then check on the device that every compacted row is strictly
ascending and inside the tile, and raise ``ValueError`` for a row that is
not: the kernel cannot reproduce list order for an unsorted row.  That
check reads one flag back to the host.  ``compacted=True`` skips both steps
for a caller that holds :func:`events_from_spikes` output, as the engine's
forward does, which then reads nothing from the device.

Every launch runs with the events' device made current and on that
device's current stream, so tensors on any card launch there, whichever
card the caller has current; a weight tile or scale on another device
than the events raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.quant import check_bits, lanes_per_byte, unpack_signmag
from repro_torch.kernels import _build


def event_synapse_plain(events: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of weights[events[r, e]]`` over the row's valid
    events (``>= 0``, wherever a ``-1`` sits), one float32 add per event in
    ascending ``e`` — the oracle's accumulation order, so the sums match it
    bit for bit."""
    r, n_events = events.shape
    out = torch.zeros(r, weights.shape[1], dtype=torch.float32,
                      device=weights.device)
    if r == 0 or n_events == 0:
        return out
    valid = events >= 0
    used = valid.any(dim=0).nonzero()
    depth = int(used[-1]) + 1 if used.numel() else 0   # last valid position
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


def compact_events(events: torch.Tensor) -> torch.Tensor:
    """Each row's valid entries moved to its front in list order, ``-1``
    after them: the stable prefix-count-and-scatter of
    :func:`events_from_spikes`, on the events' device, with no sync.  A
    view whose rows are contiguous."""
    r, n_events = events.shape
    valid = events >= 0
    pos = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1
    pos = torch.where(valid, pos, n_events)
    out = torch.full((r, n_events + 1), -1, dtype=torch.int32,
                     device=events.device)
    out.scatter_(1, pos.long(), events)
    return out[:, :n_events]


def _kernel_events(events: torch.Tensor, n_src: int,
                   compacted: bool) -> torch.Tensor:
    """The event list in the kernel's layout.  ``compacted``: the caller
    vouches for it (``events_from_spikes`` output).  Else compacted here,
    and every row checked to ascend strictly inside ``[0, n_src)``, with one
    flag read back to the host."""
    if compacted:
        return events
    ev = compact_events(events)
    nxt = ev[:, 1:]
    unsorted, outside = torch.stack([
        ((nxt >= 0) & (nxt <= ev[:, :-1])).any(),
        (ev >= n_src).any()]).tolist()
    if unsorted:
        raise ValueError(
            "event rows must hold their valid sources in strictly ascending "
            "order (-1 padding may sit anywhere): the CUDA kernel adds each "
            "row's events in ascending source chunks, which is list order "
            "only for an ascending list; sort the rows, or use the plain "
            "version on the CPU, which adds in list order")
    if outside:
        raise ValueError(f"event rows hold a source index >= n_src = {n_src}")
    return ev


def _scale_arg(scale, device: torch.device):
    """The layer scale as the kernel takes it: ``(value, None)`` for a
    Python or numpy number or a CPU tensor (read on the host, no device
    sync), ``(0.0, tensor)`` for a CUDA tensor, whose value the kernel reads
    through its pointer."""
    if isinstance(scale, torch.Tensor) and scale.is_cuda:
        if scale.numel() != 1 or scale.device != device:
            raise ValueError(f"scale must be one value on {device}, got "
                             f"{tuple(scale.shape)} on {scale.device}")
        return 0.0, scale.to(torch.float32).reshape(1).contiguous()
    return float(np.asarray(scale, dtype=np.float32).reshape(())), None


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def event_synapse_cuda(events: torch.Tensor, weights: torch.Tensor, *,
                       compacted: bool = False) -> torch.Tensor:
    """Launch the dense kernel: events i32 [R, E] (see the module's
    contract; ``compacted=True`` for :func:`events_from_spikes` output),
    weights f32 [n_src, n_dest] on one CUDA device -> currents f32
    [R, n_dest]."""
    _check_events(events)
    _check_weights(weights, events, torch.float32)
    r, n_events = events.shape
    n_dest = weights.shape[1]
    out = torch.empty(r, n_dest, dtype=torch.float32, device=events.device)
    if r == 0 or n_events == 0 or n_dest == 0:
        return out.zero_()
    ev = _kernel_events(events, weights.shape[0], compacted)
    lib = _build.library("event_synapse")
    with torch.cuda.device(events.device):
        err = lib.event_synapse_f32(ev.data_ptr(), ev.stride(0),
                                    weights.data_ptr(), weights.stride(0),
                                    out.data_ptr(), r, n_events, n_dest,
                                    _stream(events.device))
    _build.launches["event_synapse"] += 1
    _build.check(lib, err, "event_synapse")
    return out


def event_synapse_packed_cuda(events: torch.Tensor, packed_w: torch.Tensor,
                              scale, bits: int, *,
                              compacted: bool = False) -> torch.Tensor:
    """Launch the packed kernel: events i32 [R, E] (as for
    :func:`event_synapse_cuda`), packed_w i8 [n_src, n_dest * bits / 8]
    (quant.pack_signmag lanes), scale the f32 layer scale: a host number,
    passed by value, or a one-element CUDA tensor, which the kernel reads
    (neither syncs) -> currents f32 [R, n_dest]."""
    _check_events(events)
    _check_weights(packed_w, events, torch.int8)
    r, n_events = events.shape
    n_dest = packed_w.shape[1] * lanes_per_byte(bits)
    out = torch.empty(r, n_dest, dtype=torch.float32, device=events.device)
    if r == 0 or n_events == 0 or n_dest == 0:
        return out.zero_()
    scale_f, scale_t = _scale_arg(scale, events.device)
    ev = _kernel_events(events, packed_w.shape[0], compacted)
    lib = _build.library("event_synapse")
    with torch.cuda.device(events.device):
        err = lib.event_synapse_packed_i8(
            ev.data_ptr(), ev.stride(0), packed_w.data_ptr(),
            packed_w.stride(0), scale_f,
            None if scale_t is None else scale_t.data_ptr(), bits,
            out.data_ptr(), r, n_events, n_dest, _stream(events.device))
    _build.launches["event_synapse_packed"] += 1
    _build.packed_launches_by_bits[bits] += 1
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
