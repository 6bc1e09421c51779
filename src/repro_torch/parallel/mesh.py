"""An N-D device mesh driven by one process, and its collectives.

The JAX package's ``jax.sharding.Mesh`` is a grid of devices that one
controller drives through ``shard_map``; this module is its counterpart.
A :class:`Mesh` is an ordered tuple of devices, one per shard, laid out in
row-major order over named axes.  A device may repeat: ``spoof=N`` puts N
shards on one device, as the JAX package's ``--spoof-devices`` emulates an
N-device host.

A ``shard_map`` body whose collectives sit between its steps runs here in
phases: a Python loop over the shards for each phase, each shard's work
enqueued under its device's guard, and the collective between two loops.
The collectives are plain functions over the per-shard tensors of one
group (the shards that differ only along one axis, in axis order):

  * :func:`fold_sum`, psum (and pmean, divided after): float32, summed in
    shard order, shard 0 first, on the group's first device, then placed
    on every shard's device;
  * :func:`fold_max`, pmax, in the same order and placement;
  * :func:`send`, ppermute.

None of them reads a value back to the host.  Each tells an active cost
counter (:mod:`repro_torch.launch.hlo_flops`) of itself through
:func:`report`, as do the meshed pieces' point-to-point slice copies,
which all go through :func:`shard_copy`.  ``body_runs`` counts how
many times each kind of shard body ran (a probe, reset by
:func:`reset_body_runs`), so a caller can see that a meshed path really
went through every shard.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.device import canonical_device, device_guard, resolve_device

body_runs: collections.Counter = collections.Counter()


def reset_body_runs() -> None:
    body_runs.clear()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over ``axis_names`` of sizes
    ``dims`` (default: one ``("data",)`` axis over every device)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    dims: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(canonical_device(d) for d in self.devices))
        dims = tuple(self.dims) or (len(self.devices),)
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(dims) != len(self.axis_names) or len(set(self.axis_names)) \
                != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} do not name the "
                             f"dimensions {dims}")
        if math.prod(dims) != len(self.devices):
            raise ValueError(f"a {dims} mesh needs {math.prod(dims)} "
                             f"devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def real(self) -> bool:
        """Whether every shard has a device of its own (not spoofed)."""
        return len(set(self.devices)) == self.size

    def axis_index(self, shard: int, axes) -> int:
        """Shard ``shard``'s coordinate along ``axes`` (a name, or a tuple
        of names: its row-major position over them; 0 over none)."""
        if isinstance(axes, str):
            i = self.axis_names.index(axes)
            return (shard // math.prod(self.dims[i + 1:])) % self.dims[i]
        pos = 0
        for a in axes:
            pos = pos * self.shape[a] + self.axis_index(shard, a)
        return pos

    def groups(self, axes) -> list[list[int]]:
        """The shards grouped along ``axes`` (a name or a tuple of names):
        each group holds the shards that differ only in those coordinates,
        ordered by them (row-major over ``axes``); the groups are in
        row-major order of the other coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        keyed = collections.defaultdict(list)
        for s in range(self.size):
            rest = tuple(self.axis_index(s, a) for a in self.axis_names
                         if a not in axes)
            keyed[rest].append(s)
        return [keyed[k] for k in sorted(keyed)]


def split_axes(mesh: Mesh, batch: int, axes=("pod", "data")) -> tuple:
    """The axes of ``mesh`` among ``axes`` that a batch of ``batch`` shards
    over: all of them when their product divides it, else none (the batch
    is replicated)."""
    present = tuple(a for a in axes if a in mesh.axis_names)
    n = math.prod(mesh.shape[a] for a in present)
    return present if batch % n == 0 else ()


def mesh_devices(n: int | None = None, *, device="cuda",
                 spoof: int | None = None) -> tuple[torch.device, ...]:
    """The devices of an ``n``-shard mesh.  Without ``spoof``: the first
    ``n`` devices of ``device``'s kind (default all of them:
    ``torch.cuda.device_count()`` cards, or the one CPU).  With
    ``spoof=N``: ``n`` (default ``N``) shards of the one ``device``.
    Asking for more devices than exist (or than are spoofed) raises
    ``ValueError``, with no silent spoof; ``device="cuda"`` with no card
    raises as :func:`~repro_torch.device.resolve_device` does."""
    dev = resolve_device(device)
    if spoof is not None:
        if spoof < 1:
            raise ValueError(f"spoof needs at least 1 device, got {spoof}")
        n = spoof if n is None else n
        if not 1 <= n <= spoof:
            raise ValueError(f"asked for a {n}-way mesh over {spoof} "
                             f"spoofed devices")
        return (dev,) * n
    avail = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    n = len(avail) if n is None else n
    if not 1 <= n <= len(avail):
        raise ValueError(
            f"asked for a {n}-way mesh, but {len(avail)} {dev.type} "
            f"device(s) exist; spoof shards over one device with spoof=N "
            f"(--spoof-devices N)")
    return tuple(avail[:n])


def report(kind: str, nbytes: int, n_devices: int) -> None:
    """Tell every active cost counter of one collective (``kind`` one of
    ``hlo_flops.KINDS``) whose result of ``nbytes`` lands on each of
    ``n_devices`` devices.  The counters are found on the dispatch-mode
    stack, which autograd carries to its own thread, so a rematerialised
    forward run by the backward reports too; with none active, nothing
    happens."""
    for mode in _get_current_dispatch_mode_stack():
        note = getattr(mode, "record_collective", None)
        if note is not None:
            note(kind, nbytes, n_devices)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shard_copy(t: torch.Tensor, device, src: int, dst: int,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t.to(device, dtype)``: shard ``src``'s tensor as shard ``dst``
    receives it.  Reported (:func:`report`) as one ``p2p`` copy of ``t``'s
    bytes when the shards differ, whether or not their devices do: on a
    spoofed mesh the copy moves nothing, but the mesh it stands for would
    move the slice."""
    if src != dst:
        report("p2p", _nbytes(t), 1)
    return t.to(device) if dtype is None else t.to(device, dtype)


def fold_sum(parts: list[torch.Tensor], devices) -> list[torch.Tensor]:
    """psum over one group: ``parts[s]`` is shard s's tensor; the float32
    sum in shard order on ``devices[0]``, placed on each of ``devices``."""
    report("all-reduce", parts[0].numel() * 4, len(parts))
    dev0 = devices[0]
    with device_guard(dev0):
        acc = parts[0].to(dev0, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(dev0, torch.float32)
    return [acc.to(d) for d in devices]


def fold_max(parts: list[torch.Tensor], devices) -> list[torch.Tensor]:
    """pmax over one group, in :func:`fold_sum`'s order and placement."""
    report("all-reduce", _nbytes(parts[0]), len(parts))
    dev0 = devices[0]
    with device_guard(dev0):
        acc = parts[0].to(dev0)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(dev0))
    return [acc.to(d) for d in devices]


def send(parts: list[torch.Tensor], devices, perm) -> list[torch.Tensor]:
    """ppermute over one group: ``perm`` holds ``(src, dst)`` pairs of
    group positions; shard ``dst`` receives ``parts[src]`` on its device,
    and a shard that receives nothing gets zeros, as in JAX."""
    report("collective-permute", _nbytes(parts[0]), len(parts))
    out = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    for i, got in enumerate(out):
        if got is None:
            with device_guard(devices[i]):
                out[i] = torch.zeros_like(parts[i], device=devices[i])
    return out
