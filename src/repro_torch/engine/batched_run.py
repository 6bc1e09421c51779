"""Batched execution engine for the MENAGE software twin, in PyTorch.

The numpy :func:`repro_torch.core.accelerator.run` is the cycle-accurate
oracle: it walks timesteps, rounds, MEM_S&N rows and engines in Python.
This module executes the *same* mapped model — the same control-memory
content — as batched tensor code on a device:

  * :func:`pack_model` turns a :class:`MappedModel` into a
    :class:`PackedModel`: per layer, the effective weights of every round,
    replayed out of the control memories and scattered to global
    destination columns (padded to the reference's block size), as the one
    tile the synapse kernel reads; per round, the host-side dispatch
    geometry behind the statistics.
  * :func:`run_batched` executes ``spikes[B, T, n_in]`` through the chain.
    Per layer, the ``B*T`` spike vectors become padded event lists via
    ``events_from_spikes`` (the software MEM_E writer), synaptic
    accumulation runs through the ``event_synapse`` kernel, and LIF over T
    is one ``lif_scan`` launch.  On the CPU each kernel is its plain
    PyTorch version.
  * Nothing reads more of the input than ``spikes > 0``, so an engine
    call's input travels as a uint8 mask (:func:`spike_mask`; a float
    raster is turned into one on the host), a quarter of a float32
    raster's bytes.  The serving front end writes its requests straight
    into the model's staging buffer for the shape (:func:`staging`),
    pinned when the model lives on a card, so the copy to the card does
    not block the host.
  * ``donate`` is the port's counterpart of the reference's buffer
    donation: each ``(B, T)`` shape a model serves keeps one preallocated
    uint8 device input buffer, refilled with ``copy_`` on every call, so
    a serving loop over a bucket grid holds at most ``n_buckets`` input
    buffers instead of allocating one per call.
  * On a CUDA model with ``donate`` on, each ``(B, T, max_events)`` shape's
    forward is captured once as a CUDA graph reading that shape's input
    buffer (:func:`_replay`), and every later call replays it: the same
    kernels with the same arguments, issued by one host call instead of
    ~15 torch operations and two launches a layer.

Equivalence contract (tested): output spikes are **bit-identical** to the
oracle's for every batch element, and the reported :class:`DispatchStats`
aggregates match it field for field.  Events are emitted in ascending
source order, the oracle's accumulation order, and every float32 add and
multiply is rounded on its own, so even the partial sums agree.

:mod:`repro_torch.engine.sharded_run` runs the same forward per batch
shard on the devices of a mesh, each on the model's replica there
(:meth:`PackedModel.replica`).

Data layout:

  PackedModel.layers[l].rounds[r]          host geometry + stats vectors
  PackedModel.layers[l].w_fused            f32 [n_src, n_dest_pad], all rounds
  PackedModel.layers[l].w_packed           i8 [n_src, n_dest_pad*bits/8]
  input mask (staged, donated)             u8 [B, T, n_in]
  events                                   i32 [B*T, E]   (pad = -1)
  currents                                 f32 [B, T, n_dest_pad]
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from repro_torch.core.accelerator import MappedModel
from repro_torch.core.energy import (FRAME_CYCLES, AcceleratorSpec,
                                     EnergyReport, energy_model)
from repro_torch.core.lif import LIFParams
from repro_torch.core.memories import DispatchStats, stats_vectors
from repro_torch.core.quant import check_bits, lanes_per_byte, pack_signmag
from repro_torch.device import canonical_device, resolve_device
from repro_torch.engine.tracing import span
from repro_torch.kernels import _build, ops

# The reference's Pallas dest tile: kept for the padded widths, so that
# n_dest_pad equals the reference's (the CUDA kernels need no padding).
DEFAULT_BLOCK_D = 256


def _mem_e_depth(layer: "PackedLayer", max_events: int | None) -> int:
    """Static MEM_E depth for a layer: full fan-in unless capped — shared by
    the kernel dispatch and the overflow accounting, which must agree."""
    return layer.n_src if max_events is None else min(max_events, layer.n_src)


def _pad_dest(n_dest: int, block_d: int) -> int:
    """The reference's padded dest width: unpadded when a single block
    covers the layer, else the next multiple of ``block_d``."""
    if n_dest <= block_d:
        return n_dest
    return -(-n_dest // block_d) * block_d


@dataclasses.dataclass
class PackedRound:
    """One capacitor-assignment round's dispatch geometry, on the host: the
    MEM_S&N row count and row width, and the per-source (rows, cycles,
    MACs) vectors behind the batched :class:`DispatchStats`.  The round's
    weights live only in the layer's fused tile."""

    n_rows: int
    row_bytes: int
    stats: tuple[np.ndarray, np.ndarray, np.ndarray]

    def stats_vectors(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.stats


@dataclasses.dataclass
class PackedLayer:
    rounds: list[PackedRound]
    n_src: int = 0
    n_dest: int = 0
    n_dest_pad: int = 0
    # the kernel's weight tile: every round fused (None on packed layers)
    w_fused: torch.Tensor | None = None   # f32 [n_src, n_dest_pad]
    # packed-operand path (pack_model(packed_ops=True)): the layer's fused
    # weight tile as sign-magnitude codes packed ``8/bits`` destination
    # lanes per int8 byte, plus the per-tensor quant scale
    w_packed: torch.Tensor | None = None  # i8 [n_src, n_dest_pad * bits / 8]
    scale: torch.Tensor | None = None     # f32 [1, 1]
    # the same scale on the host: what the forward hands the packed
    # launcher, so that no launch reads the device
    scale_host: np.float32 | None = None
    bits: int = 8


@dataclasses.dataclass(eq=False)
class PackedModel:
    layers: list[PackedLayer]
    lif: LIFParams = LIFParams()
    spec: AcceleratorSpec | None = None
    block_d: int = DEFAULT_BLOCK_D
    device: torch.device = torch.device("cpu")
    # one reusable input buffer per (B, T) shape served with donate on
    # (per (shard, B, T) on the sharded path); not an init field, so
    # dataclasses.replace starts a model afresh
    input_buffers: dict = dataclasses.field(default_factory=dict,
                                            init=False, repr=False)
    # one host staging buffer per (B, T) shape the front end serves
    # (:func:`staging`); not an init field either
    staging: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)
    # one captured forward per (B, T, max_events) shape served with donate
    # on a card (:func:`_replay`), all in one memory pool; not init fields
    # either
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)
    graph_pool: tuple | None = dataclasses.field(default=None, init=False,
                                                 repr=False)
    # this model's copies on other devices (the sharded path), one per
    # device, made on first use
    replicas: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False)

    def __post_init__(self):
        # the index made explicit: a bare ``cuda`` would name whichever
        # card is current (under a shard's device guard, the shard's)
        self.device = canonical_device(self.device)

    @property
    def n_in(self) -> int:
        return self.layers[0].n_src

    @property
    def n_out(self) -> int:
        return self.layers[-1].n_dest

    def replica(self, device) -> "PackedModel":
        """This model on ``device``: itself where it already lives, else a
        copy of its device tensors there (host geometry shared), made once
        per device and cached."""
        dev = canonical_device(device)
        if dev == self.device:
            return self
        rep = self.replicas.get(dev)
        if rep is None:
            layers = [dataclasses.replace(
                l, **{f: getattr(l, f).to(dev)
                      for f in ("w_fused", "w_packed", "scale")
                      if getattr(l, f) is not None}) for l in self.layers]
            rep = self.replicas[dev] = PackedModel(
                layers=layers, lif=self.lif, spec=self.spec,
                block_d=self.block_d, device=dev)
        return rep

    def drop_devices(self, keep, n_shards: int) -> None:
        """Forget what the sharded path holds beyond a mesh of ``n_shards``
        shards over the devices ``keep``: the replicas on other devices,
        and the input buffers of shards at or past ``n_shards``."""
        keep = {canonical_device(d) for d in keep}
        for dev in [d for d in self.replicas if d not in keep]:
            del self.replicas[dev]
        for model in (self, *self.replicas.values()):
            for key in [k for k in model.input_buffers
                        if len(k) == 3 and k[0] >= n_shards]:
                del model.input_buffers[key]


def _pack_layer_codes(layer, w_host: np.ndarray, bits: int, device
                      ) -> tuple[torch.Tensor, torch.Tensor, np.float32]:
    """Host-side operand packing for one layer: recover the integer codes
    from the replayed (dequantized) tile and pack them into sign-magnitude
    sub-byte lanes.  Exactness is *asserted*: every stored table value must
    equal ``fl32(code * scale)`` bit for bit, which is what makes the packed
    kernel's dequantization reproduce the dense path exactly."""
    scale = np.float32(layer.scale)
    q = np.rint(w_host / scale)
    qmax = 2 ** (bits - 1) - 1
    if np.abs(q).max(initial=0) > qmax:
        raise ValueError(
            f"recovered codes exceed the {bits}-bit range [-{qmax}, {qmax}] "
            f"— layer was not quantized at {bits} bits")
    if not (q.astype(np.float32) * scale == w_host).all():
        raise ValueError(
            "packed-operand exactness violated: table values are not "
            "fl32(code * scale) — the layer's stored weights do not come "
            "from quantize_symmetric at this scale")
    w_packed = pack_signmag(q.astype(np.int8), bits)
    return (torch.from_numpy(w_packed).to(device),
            torch.tensor([[scale]], dtype=torch.float32, device=device),
            scale)


def _fused_tile(layer, n_dest_pad: int,
                weight_dict: np.ndarray | None) -> np.ndarray:
    """Replay a layer's rounds out of the control memories into one
    ``[n_src, n_dest_pad]`` f32 tile on the host: the operand of both
    synapse kernels.  Every round is walked as COO triplets
    (:meth:`MemTables.replay_coo`, the vectorised form of the per-row
    replay); compressed models gather the values from the shared
    dictionary.  Rounds target disjoint destination columns and each
    (src, dest) pair occurs at most once, so the tile equals the sum of the
    rounds' dense replays bit for bit (tested)."""
    w = np.zeros((layer.n_src, n_dest_pad), dtype=np.float32)
    for rnd in layer.rounds:
        if weight_dict is not None:
            src, dest_local, widx = rnd.tables.replay_coo_ptr()
            vals = weight_dict[widx]
        else:
            src, dest_local, vals = rnd.tables.replay_coo()
        np.add.at(w, (src, rnd.neuron_ids[dest_local]), vals)
    return w


def pack_model(model: MappedModel, block_d: int = DEFAULT_BLOCK_D,
               packed_ops: bool = False, device="cuda") -> PackedModel:
    """Build the device tensors of a mapped model on ``device`` (default
    the card; ``device="cpu"`` for the plain path).  The effective weights
    are replayed from the control memories, not taken from the original
    matrices — the engine executes what is actually in the SRAM.

    Each layer ships one fused f32 weight tile for the ``event_synapse``
    kernel.  ``packed_ops=True`` ships it instead as packed sign-magnitude
    codes (``8/bits`` destination lanes per int8 byte) plus the layer
    scale, and dispatch routes through the ``event_synapse_packed`` kernel.
    Packing asserts ``fl32(code * scale)`` reproduces the replayed values
    bit for bit, so the packed engine stays bit-exact with the dense one at
    every bit-width (tested)."""
    device = resolve_device(device)
    weight_dict = getattr(model, "weight_dict", None)
    if weight_dict is not None:
        weight_dict = np.asarray(weight_dict, dtype=np.float32)
    if packed_ops and block_d % lanes_per_byte(2):
        raise ValueError(f"packed operands need block_d divisible by "
                         f"{lanes_per_byte(2)} byte lanes; got {block_d}")
    layers = []
    for layer in model.layers:
        bits = check_bits(int(getattr(layer, "bits", 8)))
        n_dest_pad = _pad_dest(layer.n_dest, block_d)
        if packed_ops:
            # byte lanes must tile evenly: extra columns carry 0-codes,
            # contribute exact 0.0 currents, and are sliced off post-LIF
            ell = lanes_per_byte(bits)
            n_dest_pad = -(-n_dest_pad // ell) * ell
        rounds = [PackedRound(
            n_rows=rnd.tables.n_rows,
            row_bytes=(rnd.tables.bits_per_row() + 7) // 8,
            stats=stats_vectors(rnd.tables.e2a_count, rnd.tables.e2a_addr,
                                rnd.tables.sn_valid))
            for rnd in layer.rounds]
        packed_layer = PackedLayer(rounds=rounds, n_src=layer.n_src,
                                   n_dest=layer.n_dest, n_dest_pad=n_dest_pad,
                                   bits=bits)
        w_host = _fused_tile(layer, n_dest_pad, weight_dict)
        if packed_ops:
            (packed_layer.w_packed, packed_layer.scale,
             packed_layer.scale_host) = _pack_layer_codes(layer, w_host, bits,
                                                          device)
        else:
            packed_layer.w_fused = torch.from_numpy(w_host).to(device)
        layers.append(packed_layer)
    return PackedModel(layers=layers, lif=model.lif, spec=model.spec,
                       block_d=block_d, device=device)


# The first call of each (model signature, B, T, max_events) — where the
# reference's jit would trace and compile — is counted, so a serving front
# end can show that its bucket grid bounds the distinct shapes the engine
# sees.  The signature is what the reference's jit cache keys on: the
# layer shapes, operand route, LIF constants and device, not the weights,
# so a same-shape hot-swap or noisy twin adds no new shapes.
_trace_count = 0
_seen_shapes: set = set()
_trace_listeners: list = []


def trace_count() -> int:
    """How many distinct ``(model signature, B, T, max_events)`` calls the
    engine has seen — the shape-cache probe used by tests and the serving
    layer."""
    return _trace_count


def add_trace_listener(fn) -> None:
    """Subscribe ``fn(kind, donated)`` to new-shape events — called once per
    shape the engine has not seen (kind ``"batched"``, or ``"sharded"``
    on a mesh); a listener that raises is ignored."""
    if fn not in _trace_listeners:
        _trace_listeners.append(fn)


def remove_trace_listener(fn) -> None:
    if fn in _trace_listeners:
        _trace_listeners.remove(fn)


def _signature(packed: PackedModel) -> tuple:
    return (str(packed.device), dataclasses.astuple(packed.lif),
            tuple((l.n_src, l.n_dest_pad, l.bits, l.w_packed is not None)
                  for l in packed.layers))


def _note_shape(packed: PackedModel, b: int, t: int,
                max_events: int | None, donated: bool = False,
                mesh=None) -> None:
    """Count a first call of this shape: kind ``"batched"``, or
    ``"sharded"`` with the mesh's devices in the key (the reference's
    sharded jit caches per mesh)."""
    global _trace_count
    key = (_signature(packed), b, t, max_events)
    kind = "batched"
    if mesh is not None:
        kind = "sharded"
        key = (kind, tuple(str(d) for d in mesh.devices), *key)
    if key in _seen_shapes:
        return
    _seen_shapes.add(key)
    _trace_count += 1
    for fn in list(_trace_listeners):
        try:
            fn(kind, donated)
        except Exception:
            pass


def should_donate(donate: bool | None, device="cuda") -> bool:
    """Resolve a ``donate`` tri-state for a model on ``device``: ``None``
    means on for a CUDA model and off on the CPU, as the reference's
    default is on off the CPU backend."""
    if donate is not None:
        return bool(donate)
    return torch.device(device).type == "cuda"


def spike_mask(x) -> np.ndarray:
    """``x > 0`` as a uint8 array, all of the input the engine reads; a
    uint8 array as it is."""
    x = np.asarray(x)
    return x if x.dtype == np.uint8 else np.greater(x, 0).view(np.uint8)


class Staging:
    """One ``(B, T)`` shape's host staging buffer: the uint8 ``> 0`` mask
    ``[B, T, n_in]`` that the front end writes an engine call's requests
    into (:meth:`fill`), pinned when the model lives on a card so that
    :func:`_upload` copies it without blocking the host.

    Reuse is safe: a shape's buffer is written again only by that shape's
    next call, which starts after this call's ``engine.readback`` has
    synchronised the stream, and so after the copy has finished."""

    __slots__ = ("mask", "steps")

    def __init__(self, shape: tuple, pinned: bool):
        self.mask = (torch.zeros(shape, dtype=torch.uint8,
                                 pin_memory=True).numpy() if pinned
                     else np.zeros(shape, dtype=np.uint8))
        self.steps = [0] * shape[0]     # rows past these are zero

    def fill(self, rows) -> np.ndarray:
        """Row ``r`` of the mask is ``rows[r] > 0`` over its steps; every
        step no row holds this call is zero.  Only what an earlier, longer
        fill left behind is zeroed again."""
        mask, steps = self.mask, self.steps
        for r, x in enumerate(rows):
            t = x.shape[0]
            np.greater(x, 0, out=mask[r, :t])
            if steps[r] > t:
                mask[r, t:steps[r]] = 0
            steps[r] = t
        for r in range(len(rows), len(steps)):
            if steps[r]:
                mask[r, :steps[r]] = 0
                steps[r] = 0
        return mask


def staging(packed: PackedModel, b: int, t: int) -> Staging:
    """The model's staging buffer for the ``(b, t)`` shape, made on first
    use: pinned on a card, plain host memory on the CPU."""
    buf = packed.staging.get((b, t))
    if buf is None:
        buf = packed.staging[(b, t)] = Staging(
            (b, t, packed.n_in), pinned=packed.device.type == "cuda")
    return buf


# Bytes of engine input masks put on the model's device, and how many
# uploads carried them (one per engine call, one per shard on a mesh).
upload_counts = {"bytes": 0, "uploads": 0}


def _upload(packed: PackedModel, host: np.ndarray, donate: bool,
            shard: int | None = None) -> torch.Tensor:
    """The input's spike mask (:func:`spike_mask`) on the model's device:
    with ``donate`` on, copied into the model's uint8 buffer for this
    ``(B, T)`` shape (``(shard, B, T)`` for a shard of the sharded path,
    so that two shards never share one), made on first use; else a new
    tensor.  The copy does not wait: from a pinned staging buffer it runs
    behind the host on the stream, and from pageable memory CUDA has
    taken the bytes when the call returns."""
    mask = spike_mask(host)
    upload_counts["bytes"] += mask.nbytes
    upload_counts["uploads"] += 1
    src = torch.from_numpy(mask)
    if not donate:
        return src.to(packed.device, non_blocking=True)
    key = mask.shape[:2] if shard is None else (shard, *mask.shape[:2])
    buf = packed.input_buffers.get(key)
    if buf is None:
        buf = packed.input_buffers[key] = torch.empty(
            mask.shape, dtype=torch.uint8, device=packed.device)
    return buf.copy_(src, non_blocking=True)


def _forward_impl(packed: PackedModel, spikes: torch.Tensor,
                  max_events: int | None) -> list[torch.Tensor]:
    """Per-layer output spike trains ([B, T, n_dest] each; the last entry is
    the model output).  Dispatch = MEM_E write + event_synapse kernel; LIF =
    one lif_scan launch per layer.  Nothing here reads the device: the event
    lists come compacted from the MEM_E writer, and the packed route's scale
    from the host."""
    b, t, _ = spikes.shape
    outs = []
    for layer in packed.layers:
        events = ops.events_from_spikes(spikes.reshape(b * t, layer.n_src),
                                        _mem_e_depth(layer, max_events))
        if layer.w_packed is not None:
            currents = ops.event_synapse_packed(
                events, layer.w_packed, layer.scale_host, bits=layer.bits,
                compacted=True)
        else:
            currents = ops.event_synapse(events, layer.w_fused,
                                         compacted=True)
        out = ops.lif_scan(currents.reshape(b, t, layer.n_dest_pad),
                           packed.lif)
        spikes = out[..., :layer.n_dest]
        outs.append(spikes)
    return outs


@dataclasses.dataclass
class _Graph:
    """One shape's captured forward: the graph, its static per-layer
    outputs, what it was captured on (:func:`_operands`), and the kernel
    launches its capture recorded, which each replay counts again."""

    graph: torch.cuda.CUDAGraph
    outs: list[torch.Tensor]
    operands: tuple
    launches: dict
    by_bits: dict


def _operands(packed: PackedModel, spikes: torch.Tensor) -> tuple:
    """What a captured forward has baked into its kernels' arguments: the
    input buffer's and every weight tile's address, the packed route's
    host scale and width, and the LIF constants.  A graph captured on
    other operands is stale."""
    return (spikes.data_ptr(), packed.lif,
            tuple((l.w_fused if l.w_packed is None else l.w_packed).data_ptr()
                  for l in packed.layers),
            tuple((l.scale_host, l.bits) for l in packed.layers))


def _counts() -> tuple[dict, dict]:
    return dict(_build.launches), dict(_build.packed_launches_by_bits)


def _add_counts(launches: dict, by_bits: dict, sign: int = 1) -> None:
    for counts, delta in ((_build.launches, launches),
                          (_build.packed_launches_by_bits, by_bits)):
        for k, v in delta.items():
            counts[k] += sign * v


def _capture(packed: PackedModel, spikes: torch.Tensor,
             max_events: int | None, operands: tuple) -> _Graph:
    """Capture ``_forward_impl`` on ``spikes`` as one CUDA graph, on a side
    stream, into the model's graph pool.  Nothing runs on the card: the
    launch counts the capture bumped are taken back, and each replay adds
    them.

    The model's graphs share one pool.  A graph's outputs stay allocated
    while it lives, so no other capture takes them; its scratch may be
    another graph's scratch or outputs.  That is safe because replays run
    one at a time on the current stream and each replay's outputs are
    copied out before the next (:func:`run_batched`).

    The cyclic garbage collector is off while the graph captures: a
    pinned staging buffer it freed there would record an event on the
    stream its copy ran on, which ends the capture."""
    cur = torch.cuda.current_stream(packed.device)
    side = torch.cuda.Stream(packed.device)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    if packed.graph_pool is None:
        packed.graph_pool = torch.cuda.graph_pool_handle()
    before = _counts()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(packed.device), torch.cuda.stream(side):
            graph.capture_begin(pool=packed.graph_pool,
                                capture_error_mode="thread_local")
            try:
                outs = _forward_impl(packed, spikes, max_events)
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    cur.wait_stream(side)
    after = _counts()
    delta = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
             for a, b in zip(after, before)]
    _add_counts(*delta, sign=-1)
    return _Graph(graph, outs, operands, *delta)


def _replay(packed: PackedModel, spikes: torch.Tensor,
            max_events: int | None) -> list[torch.Tensor]:
    """``_forward_impl`` by replaying this shape's captured graph, whose
    static input is ``spikes`` (the model's donated buffer, refilled by
    :func:`_upload`).  The first call of a shape, or of a shape whose
    operands changed, answers with an eager forward, which warms the
    launchers, and then captures.  A replay returns the graph's static
    outputs: the next replay overwrites them, so the caller copies them
    out first."""
    b, t, _ = spikes.shape
    key = (b, t, max_events)
    operands = _operands(packed, spikes)
    entry = packed.graphs.get(key)
    if entry is None or entry.operands != operands:
        packed.graphs.pop(key, None)
        outs = _forward_impl(packed, spikes, max_events)
        packed.graphs[key] = _capture(packed, spikes, max_events, operands)
        return outs
    with span("engine.replay"):
        entry.graph.replay()
    _add_counts(entry.launches, entry.by_bits)
    return entry.outs


# ------------------------------------------------------------ batched result

@dataclasses.dataclass
class BatchedDispatchStats:
    """Per-sample, per-step dispatch statistics (``[B, T]`` int64 arrays);
    ``sample(b)`` recovers the oracle's :class:`DispatchStats` exactly."""

    cycles: np.ndarray
    rows_touched: np.ndarray
    engine_ops: np.ndarray
    events: np.ndarray
    sn_bytes_touched: np.ndarray
    mem_e_peak: np.ndarray      # [B]

    def sample(self, b: int) -> DispatchStats:
        return DispatchStats(
            cycles=self.cycles[b], rows_touched=self.rows_touched[b],
            engine_ops=self.engine_ops[b], events=self.events[b],
            sn_bytes_touched=self.sn_bytes_touched[b],
            mem_e_peak=int(self.mem_e_peak[b]))


@dataclasses.dataclass
class BatchedRunResult:
    out_spikes: np.ndarray                       # [B, T, n_out]
    per_layer_stats: list[BatchedDispatchStats]
    per_layer_util: list[np.ndarray]             # [B, T] float64
    overflow: list[np.ndarray]                   # [B, T] events dropped
    spec: AcceleratorSpec | None = None
    per_layer_bits: list[int] | None = None      # stored word widths (energy)

    @property
    def batch(self) -> int:
        return self.out_spikes.shape[0]

    def sample_stats(self, b: int) -> list[DispatchStats]:
        return [s.sample(b) for s in self.per_layer_stats]

    def sample_energy(self, b: int,
                      frame_cycles: int | None = FRAME_CYCLES) -> EnergyReport:
        """Same signature as :func:`repro_torch.core.energy.energy_model`:
        ``frame_cycles`` defaults to the calibrated frame period, ``None``
        means throughput mode."""
        if self.spec is None:
            raise ValueError("pack_model carried no AcceleratorSpec")
        return energy_model(self.spec, self.sample_stats(b),
                            frame_cycles=frame_cycles,
                            per_core_bits=self.per_layer_bits)


def _layer_stats(in_spikes: np.ndarray, layer: PackedLayer,
                 max_events: int | None,
                 sn_capacity_rows: int | None
                 ) -> tuple[BatchedDispatchStats, np.ndarray, np.ndarray]:
    """Vectorized dispatch accounting for one layer: every per-step counter
    is a dot product of the accepted-event raster with a per-source table
    vector, reproducing the oracle's Python accumulation in int64.

    A finite MEM_E depth accepts only the ``depth`` lowest source indices
    per step (FIFO write order) — dropped events arrive (``events``) but
    dispatch nothing, exactly as the kernel path truncates them."""
    sp = (in_spikes > 0)
    b, t, _ = sp.shape
    depth = _mem_e_depth(layer, max_events)
    if depth >= layer.n_src:
        keep = sp                       # cap can never bind
    else:
        keep = sp & (np.cumsum(sp, axis=2) <= depth)
    shape = (b, t)
    cycles = np.zeros(shape, dtype=np.int64)
    rows = np.zeros(shape, dtype=np.int64)
    mac = np.zeros(shape, dtype=np.int64)
    bytes_t = np.zeros(shape, dtype=np.int64)
    util = np.zeros(shape, dtype=np.float64)
    total_rows = sum(r.n_rows for r in layer.rounds)
    cap = sn_capacity_rows or max(total_rows, 1)
    for rnd in layer.rounds:
        rows_v, cyc_v, ops_v = rnd.stats_vectors()
        r_rows = keep @ rows_v
        cycles += keep @ cyc_v
        rows += r_rows
        mac += keep @ ops_v
        bytes_t += r_rows * rnd.row_bytes
        util += r_rows.astype(np.float64) / cap
    events = sp.sum(axis=2, dtype=np.int64)
    overflow = np.maximum(events - depth, 0)
    stats = BatchedDispatchStats(cycles=cycles, rows_touched=rows,
                                 engine_ops=mac, events=events,
                                 sn_bytes_touched=bytes_t,
                                 mem_e_peak=np.minimum(events, depth)
                                 .max(axis=1, initial=0))
    return stats, util, overflow


def _finalize(packed: PackedModel, in_spikes: np.ndarray,
              layer_outs: list[np.ndarray], max_events: int | None,
              sn_capacity_rows: int | None,
              with_stats: bool) -> BatchedRunResult:
    """Host copies of the layer outputs -> :class:`BatchedRunResult`,
    including the host-side dispatch accounting."""
    out = layer_outs[-1]
    bits = [l.bits for l in packed.layers]
    if not with_stats:
        return BatchedRunResult(out_spikes=out, per_layer_stats=[],
                                per_layer_util=[], overflow=[],
                                spec=packed.spec, per_layer_bits=bits)
    stats_all, util_all, drop_all = [], [], []
    layer_in = in_spikes
    with span("engine.stats"):
        for li, layer in enumerate(packed.layers):
            stats, util, overflow = _layer_stats(layer_in, layer, max_events,
                                                 sn_capacity_rows)
            stats_all.append(stats)
            util_all.append(util)
            drop_all.append(overflow)
            layer_in = layer_outs[li]
    return BatchedRunResult(out_spikes=out, per_layer_stats=stats_all,
                            per_layer_util=util_all, overflow=drop_all,
                            spec=packed.spec, per_layer_bits=bits)


def run_batched(model: MappedModel | PackedModel, in_spikes, *,
                max_events: int | None = None,
                sn_capacity_rows: int | None = None,
                with_stats: bool = True,
                donate: bool | None = None,
                device=None) -> BatchedRunResult:
    """Execute a batch of spike trains ``[B, T, n_in]`` through the chain.

    ``in_spikes`` is a uint8 spike mask, taken as it is, or a raster of
    any other dtype, of which only ``> 0`` is read (:func:`spike_mask`).
    A :class:`PackedModel` runs on its own device; a :class:`MappedModel`
    is packed onto ``device`` first (default the card — with no card, pass
    ``device="cpu"``).

    Bit-exact vs. the oracle ``run`` called with the same ``max_events``
    (tested, including finite caps).  A tight ``max_events`` models the
    finite MEM_E depth: excess events are dropped lowest-priority-last
    (ascending source index kept) before dispatch, counted per step in
    ``result.overflow``, and the loss propagates to downstream layers
    through the LIF exactly as on the oracle.

    Degenerate shapes are valid inputs: ``B=0`` returns an empty result,
    ``T=1`` and all-silent batches follow the ordinary path.
    ``with_stats=False`` skips the host-side accounting.  ``donate``
    refills the model's buffer for this ``(B, T)`` shape instead of
    allocating a new input tensor (default: on for a CUDA model, off on
    the CPU; see :func:`should_donate`); on a card it also replays the
    shape's captured forward (:func:`_replay`), bit-identical to issuing
    it.
    """
    if isinstance(model, PackedModel):
        packed = model
        if (device is not None
                and canonical_device(resolve_device(device)) != packed.device):
            raise ValueError(f"model is packed on {packed.device}, "
                             f"not {device}")
    else:
        packed = model.pack(device="cuda" if device is None else device)
    host = np.asarray(in_spikes)
    if host.ndim != 3 or host.shape[2] != packed.n_in:
        raise ValueError(f"expected [B, T, {packed.n_in}], got {host.shape}")
    b, t, _ = host.shape
    donate = should_donate(donate, packed.device)
    _note_shape(packed, b, t, max_events, donate)
    # stage spans: the upload, the issue of every layer's kernels (or the
    # replay of their graph), and the readback, where the host waits for
    # the card
    with span("engine.upload"):
        spikes = _upload(packed, host, donate)
    # a card's donated buffer is a static input: replay that shape's graph
    graphed = donate and packed.device.type == "cuda" and b * t > 0
    with span("engine.forward"):
        outs = (_replay if graphed else _forward_impl)(packed, spikes,
                                                      max_events)
    with span("engine.readback"):
        layer_outs = [o.cpu().numpy() for o in outs]
    return _finalize(packed, host, layer_outs, max_events, sn_capacity_rows,
                     with_stats)
