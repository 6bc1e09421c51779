"""Data-parallel sharded serving of the batched MENAGE engine.

:func:`run_sharded` executes the same packed model as ``run_batched``, over
a :class:`ServeMesh`: the spike batch is split along its first axis into
contiguous shards in mesh order, and each shard runs the very same
``batched_run._forward_impl`` on its device, on the model's replica there
(:meth:`~repro_torch.engine.batched_run.PackedModel.replica`: the fused
weight tiles copied once per device), mirroring how the silicon
replicates a full MX-NEURACORE chain per die.  Which batches shard follows
the reference's serving rule (``SNN_SERVE_RULES``: ``event_batch`` over
the data axis when the batch divides, else replicated): a batch the mesh
cannot split evenly runs on the mesh's first device alone instead of
failing.

A mesh is an ordered tuple of devices driven by one process, as the
reference's single-controller ``shard_map`` drives its devices: there is no
launcher, rendezvous or per-rank server.  :func:`snn_serve_mesh` takes the
first ``n`` cards, or ``spoof=N`` logical shards over one device (the
counterpart of the reference's ``--spoof-devices``, which emulates an
N-device host), and :func:`shrink_mesh` cuts a mesh to its survivors after
a device loss.

Equivalence contract (tested, ``tests/test_torch_sharded.py``): every
sample's dispatch is independent — the kernels work per (row, dest block)
and the LIF scan never mixes batch rows — so sharding the batch axis
cannot change any bit.  The layer outputs are gathered on the host in
shard order and one ``_finalize`` runs over the whole raster, so
``run_sharded`` returns the identical :class:`BatchedRunResult` surface
(spikes, DispatchStats, utilization, overflow, energy) as ``run_batched``,
and therefore stays bit-exact against the numpy oracle.

Serving notes:

  * every shard's forward is enqueued on its device before the first
    device-to-host copy, so the cards run side by side;
  * the shared ``trace_count()`` probe counts this path too (kind
    ``"sharded"``, keyed by the mesh's devices), and with ``donate`` on
    each shard refills its own input buffer, keyed by shard, so two shards
    of a spoofed mesh never share one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import device_guard
from repro_torch.engine import batched_run as br
from repro_torch.parallel.mesh import Mesh, mesh_devices


class DeviceLossError(RuntimeError):
    """Devices dropped out mid-serving.  Raised by hardware watchdogs in
    production and by chaos hooks in the soak harness
    (:mod:`repro_torch.engine.chaos`);
    :class:`~repro_torch.engine.stream_server.StreamServer` catches it at
    the dispatch boundary and recovers onto the shrunken mesh (the
    replicated models need no state movement, so recovery is a re-shard
    of future batches, not a reload)."""

    def __init__(self, n_lost: int = 1, detail: str = ""):
        self.n_lost = int(n_lost)
        msg = f"lost {self.n_lost} device(s) mid-serving"
        super().__init__(msg + (f": {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class ServeMesh(Mesh):
    """A 1-D ``("data",)`` serving mesh: an ordered tuple of devices, one
    per shard.  A device may repeat (a spoofed mesh)."""

    def __post_init__(self):
        super().__post_init__()
        if self.axis_names != ("data",):
            raise ValueError(f"a serving mesh has one data axis, not "
                             f"{self.axis_names}")


def snn_serve_mesh(n_data: int | None = None, *, device="cuda",
                   spoof: int | None = None) -> ServeMesh:
    """The serving topology for pure-DP event streaming: a 1-D mesh over
    :func:`~repro_torch.parallel.mesh.mesh_devices` (the first ``n_data``
    devices of ``device``'s kind, or ``spoof=N`` shards of the one
    ``device``; asking for more than exist raises ``ValueError``)."""
    return ServeMesh(mesh_devices(n_data, device=device, spoof=spoof))


def shrink_mesh(mesh: ServeMesh, n_lost: int) -> ServeMesh:
    """The serving mesh after ``n_lost`` devices drop: the first
    ``size - n_lost`` devices.  Because every device holds the full model,
    any subset of survivors can serve.  Raises :class:`DeviceLossError`
    when no device survives (nothing to recover onto)."""
    survivors = mesh.size - n_lost
    if survivors < 1:
        raise DeviceLossError(n_lost, f"all {mesh.size} devices lost")
    return ServeMesh(mesh.devices[:survivors])


def batch_spec(mesh: ServeMesh, shape) -> tuple:
    """The partition of a ``[B, T, n_in]`` spike tensor under the SNN
    serving rule: the batch over the mesh's data axis when it divides,
    else ``None`` (replicated); time and neurons stay local."""
    axis = mesh.axis_names[0]
    return (axis if shape[0] % mesh.size == 0 else None, None, None)


def n_batch_shards(mesh: ServeMesh, batch: int) -> int:
    """How many ways ``batch`` actually splits on ``mesh`` (1 = replicated)."""
    return mesh.size if batch_spec(mesh, (batch, 1, 1))[0] is not None else 1


def forward_shards(packed: "br.PackedModel", shards, devices,
                   max_events: int | None) -> list[list[torch.Tensor]]:
    """Enqueue each shard's forward on its device: ``shards[s]`` is shard
    ``s``'s raster on ``devices[s]``, run on the model's replica there
    under that device's guard.  Reads nothing back; returns each shard's
    per-layer output spikes on its device."""
    outs = []
    for dev, x in zip(devices, shards):
        with device_guard(dev):
            outs.append(br._forward_impl(packed.replica(dev), x, max_events))
    return outs


def run_sharded(model, in_spikes, *, mesh: ServeMesh | None = None,
                max_events: int | None = None,
                sn_capacity_rows: int | None = None,
                with_stats: bool = True,
                donate: bool | None = None) -> "br.BatchedRunResult":
    """``run_batched`` over a device mesh: spikes ``[B, T, n_in]`` split on
    the batch axis, the model replicated, results gathered back into the
    identical :class:`BatchedRunResult` surface.

    ``mesh`` defaults to :func:`snn_serve_mesh` over every card.  ``B``
    should be a multiple of the mesh's size for actual parallelism (the
    serving bucket policy guarantees it; see ``BucketPolicy.for_mesh``); a
    batch that does not divide runs replicated, on the mesh's first device
    alone.  A mapped model is packed onto that device.  ``donate`` refills
    one uint8 input buffer per (shard, shape) (default: on for a CUDA mesh).
    """
    mesh = snn_serve_mesh() if mesh is None else mesh
    packed = (model if isinstance(model, br.PackedModel)
              else model.pack(device=mesh.devices[0]))
    host = np.asarray(in_spikes)
    if host.ndim != 3 or host.shape[2] != packed.n_in:
        raise ValueError(f"expected [B, T, {packed.n_in}], got {host.shape}")
    b, t, _ = host.shape
    if b == 0:
        # nothing to shard; the single-device path owns the empty batch
        return br.run_batched(packed, host, max_events=max_events,
                              sn_capacity_rows=sn_capacity_rows,
                              with_stats=with_stats)
    n = n_batch_shards(mesh, b)
    donate = br.should_donate(donate, mesh.devices[0])
    br._note_shape(packed, b, t, max_events, donate, mesh=mesh)
    size = b // n
    devices = mesh.devices[:n]
    shards = []
    for s, dev in enumerate(devices):
        with device_guard(dev):
            shards.append(br._upload(packed.replica(dev),
                                     host[s * size:(s + 1) * size], donate,
                                     shard=s))
    outs = forward_shards(packed, shards, devices, max_events)
    # every shard is enqueued before the first copy back
    layer_outs = [np.concatenate([o[li].cpu().numpy() for o in outs])
                  for li in range(len(packed.layers))]
    return br._finalize(packed, host, layer_outs, max_events,
                        sn_capacity_rows, with_stats)
