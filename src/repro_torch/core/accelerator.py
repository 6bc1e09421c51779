"""End-to-end MENAGE accelerator simulation (paper Fig. 1 + Algorithm 1).

A MENAGE instance is a chain of MX-NEURACOREs, one per model layer.  Mapping
a trained+pruned+quantized SNN — a list of layer specs: bare matrices /
``Dense``, or ``Conv2d`` lowered with shared weight-SRAM words (see
:mod:`repro_torch.core.layers`) — onto an :class:`AcceleratorSpec` produces, per
layer: an ILP mapping solution, the three control memories, and the A-SYN
weight SRAM.  ``run`` then executes a spike train through the chain with the
cycle-level dispatch simulator driving discrete-time LIF virtual neurons —
the software twin of the silicon.

Correctness contract (tested): the accelerator simulation's output spike
counts equal the dense reference SNN's (same LIF params, same quantized
weights) for every neuron the ILP assigned, and the ILP assigns all neurons
whenever capacity M*N >= layer width.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import (FRAME_CYCLES, AcceleratorSpec,
                                     EnergyReport, energy_model)
from repro_torch.core.layers import Conv2d, LayerSpec, as_layer_spec
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import (MappingError, MappingProblem,
                                      MappingSolution, solve_mapping)
from repro_torch.core.memories import (DispatchStats, MemTables,
                                       WeightCompression,
                                       build_event_memories,
                                       compress_weight_words,
                                       dispatch_simulate, mem_sn_utilization)
from repro_torch.core.quant import check_bits, quantize_symmetric


@dataclasses.dataclass
class MappedRound:
    """One capacitor-assignment round (§III-D: once a neuron's connections
    are processed its capacitor is reassigned — layers wider than M*N run in
    ceil(n_dest / M*N) sequential rounds, each with its own ILP solve)."""

    neuron_ids: np.ndarray     # global dest indices handled this round
    mapping: MappingSolution   # indices local to neuron_ids
    tables: MemTables


@dataclasses.dataclass
class MappedLayer:
    w_q: np.ndarray            # unrolled dequantized int8 synaptic matrix
    rounds: list[MappedRound]
    n_src: int
    n_dest: int
    layer_spec: LayerSpec | None = None   # quantized Dense/Conv2d spec
    weight_bytes: int = 0      # unique stored bytes (kernel taps for conv)
    sram_bytes: int = 0        # A-SYN bytes physically allocated: words
                               # (a tap shared across engines/rounds is stored
                               # once per engine per round that references it)
                               # priced at the layer's actual word bit-width
    bits: int = 8              # stored weight bit-width (sign-magnitude)
    scale: float = 1.0         # per-tensor symmetric quantization scale

    @property
    def shared_weights(self) -> bool:
        """True when MEM_S&N rows share SRAM words (conv lowering)."""
        return isinstance(self.layer_spec, Conv2d)

    @property
    def mapping(self) -> MappingSolution:  # convenience: first round
        return self.rounds[0].mapping

    @property
    def tables(self) -> MemTables:
        return self.rounds[0].tables

    @property
    def n_assigned(self) -> int:
        return sum(r.mapping.n_assigned for r in self.rounds)


@dataclasses.dataclass
class MappedModel:
    spec: AcceleratorSpec
    layers: list[MappedLayer]
    lif: LIFParams
    # set by map_model(compress=True): the cross-round/cross-layer shared
    # dictionary of unique quantized A-SYN words (every round's
    # MemTables.weight_ptr indexes it) + the compression accounting
    weight_dict: np.ndarray | None = None
    compression: WeightCompression | None = None

    def pack(self, block_d: int | None = None,
             packed_ops: bool | None = None, device="cuda"):
        """Pack into the batched engine's tensors on ``device`` (see
        :mod:`repro_torch.engine.batched_run`), memoized per (block size,
        operand layout, device) — the table replay and device transfer
        happen once, not per batch.  ``packed_ops`` selects the sub-byte
        packed-operand kernel path; ``None`` auto-enables it iff any layer
        is quantized below 8 bits (see
        :func:`repro_torch.engine.batched_run.pack_model`)."""
        from repro_torch.engine.batched_run import DEFAULT_BLOCK_D, pack_model
        from repro_torch.device import resolve_device
        block_d = DEFAULT_BLOCK_D if block_d is None else block_d
        if packed_ops is None:
            packed_ops = any(l.bits < 8 for l in self.layers)
        device = resolve_device(device)
        cache = self.__dict__.setdefault("_packed_cache", {})
        key = (block_d, bool(packed_ops), str(device))
        if key not in cache:
            cache[key] = pack_model(self, block_d=block_d,
                                    packed_ops=packed_ops, device=device)
        return cache[key]


def map_model(weights: "list[np.ndarray | LayerSpec]", spec: AcceleratorSpec,
              lif: LIFParams = LIFParams(),
              quant_bits: "int | list[int] | tuple[int, ...]" = 8,
              fanout: int | None = None,
              method: str = "auto", compress: bool = False) -> MappedModel:
    """Algorithm 1 steps 3-5: quantize, ILP-map, build config memories.

    weights: list of layer specs, one per layer — bare ``(n_in, n_out)``
    pruned float matrices (treated as :class:`~repro_torch.core.layers.Dense`) or
    :class:`~repro_torch.core.layers.Conv2d` specs.  Convolutions are quantized at
    the *kernel*, unrolled to their sparse per-output synaptic matrix, and
    lowered with shared A-SYN SRAM words (one stored tap, many MEM_S&N rows
    pointing at it) — the SRAM budget check counts unique kernel bytes, not
    unrolled synapses.  Each layer must fit one MX-NEURACORE's weight SRAM;
    layers wider than M*N run in multiple capacitor-reassignment rounds.

    ``quant_bits`` sets the stored weight bit-width: a single int for every
    layer, or one per layer (mixed precision).  A layer spec's own ``bits``
    field, when set, wins over both.  Words are sign-magnitude C2C ladder
    codes (:data:`repro_torch.core.quant.SUPPORTED_BITS`); SRAM accounting prices
    them at their actual width, and sub-8-bit layers execute through the
    packed-operand kernel path in the batched engine.

    ``compress=True`` turns on the two-level synapse compression
    (arXiv:2112.07019): per-engine *value* dedup inside
    :func:`build_event_memories` (identical quantized words on one engine
    share a slot) plus the cross-round/cross-layer shared word dictionary
    (:func:`compress_weight_words`).  Execution is bit-exact either way —
    only the allocation accounting (``n_weight_words`` / ``sram_bytes``),
    the weight-address field width, and the engine's replay route change;
    the SRAM fit is then checked against the compressed allocation.
    """
    if len(weights) > spec.n_cores:
        raise MappingError(f"model has {len(weights)} layers but "
                           f"{spec.name} has {spec.n_cores} cores")
    if isinstance(quant_bits, (list, tuple)):
        if len(quant_bits) != len(weights):
            raise ValueError(
                f"quant_bits has {len(quant_bits)} entries for "
                f"{len(weights)} layers")
        default_bits = [check_bits(int(b)) for b in quant_bits]
    else:
        default_bits = [check_bits(int(quant_bits))] * len(weights)
    layers = []
    prev: LayerSpec | None = None
    for li, layer_in in enumerate(weights):
        ls = as_layer_spec(layer_in)
        if prev is not None and ls.n_src != prev.n_dest:
            raise ValueError(
                f"layer {li} expects {ls.n_src} inputs but layer {li-1} "
                f"produces {prev.n_dest}")
        prev = ls
        # spec-pinned bit-width wins over the map_model default(s)
        bits = check_bits(ls.bits) if ls.bits is not None else default_bits[li]
        # quantize the STORED tensor (kernel for conv, matrix for dense) so
        # synapses sharing an SRAM word carry identical dequantized values
        stored = np.asarray(ls.stored_weights)
        qt = quantize_symmetric(stored, bits=bits)
        scale = float(np.asarray(qt.scale))
        ls_q = ls.with_stored(np.asarray(qt.dequantize()) * (stored != 0))
        ls_q = dataclasses.replace(ls_q, bits=bits)
        nz_bytes = ls_q.unique_weight_bytes   # words priced at `bits` wide
        # necessary condition, checked before the (expensive) ILP; the
        # sufficient physical-allocation check follows the rounds loop.
        # (Skipped under compression: value dedup can fit a layer whose
        # unique-byte count alone overflows the budget.)
        if not compress and nz_bytes > spec.weight_mem_bytes:
            raise MappingError(f"layer {li}: {nz_bytes} B of weights > "
                               f"{spec.weight_mem_bytes} B SRAM")
        w_q = np.asarray(ls_q.unroll())
        share = ls_q.share_ids()
        n_src, n_dest = ls_q.n_src, ls_q.n_dest
        # multi-round ILP: solve, peel off assigned neurons, re-solve on the
        # remainder (capacitor reassignment, §III-D)
        remaining = np.arange(n_dest)
        rounds: list[MappedRound] = []
        while len(remaining):
            w_sub = w_q[:, remaining]
            prob = MappingProblem.from_weights(w_sub, spec.n_engines,
                                               spec.n_caps, fanout=fanout)
            sol = solve_mapping(prob, method=method)
            sol.check(prob)
            if sol.n_assigned == 0:
                raise MappingError(
                    f"layer {li}: ILP cannot assign any of the remaining "
                    f"{len(remaining)} neurons (fan-out too tight)")
            tables = build_event_memories(
                w_sub, sol, spec.n_engines, spec.n_caps,
                share_ids=None if share is None else share[:, remaining],
                dedup=compress, word_bits=bits)
            rounds.append(MappedRound(neuron_ids=remaining.copy(),
                                      mapping=sol, tables=tables))
            remaining = remaining[sol.engine < 0]
        layers.append(MappedLayer(w_q=w_q, rounds=rounds,
                                  n_src=n_src, n_dest=n_dest,
                                  layer_spec=ls_q, weight_bytes=nz_bytes,
                                  bits=bits, scale=scale))
    weight_dict = None
    compression = None
    if compress:
        compression = compress_weight_words(
            [r.tables for layer in layers for r in layer.rounds])
        weight_dict = layers[0].rounds[0].tables.weight_dict if layers else None
    for li, layer in enumerate(layers):
        # the hardware-fit guarantee: words PHYSICALLY allocated, priced at
        # the layer's word width.  A shared tap is stored once per engine per
        # round that references it (each engine's A-SYN slice is private), so
        # this exceeds weight_bytes for conv; for dense it is the
        # assigned-synapse count.  Compressed: n_weight_words counts only
        # words newly contributed to the shared dictionary, so the budget
        # buys strictly bigger models.
        n_words = sum(r.tables.n_weight_words for r in layer.rounds)
        layer.sram_bytes = -(-n_words * layer.bits // 8)
        if layer.sram_bytes > spec.weight_mem_bytes:
            raise MappingError(
                f"layer {li}: mapping stores {layer.sram_bytes} B across "
                f"{len(layer.rounds)} round(s) > {spec.weight_mem_bytes} B "
                f"SRAM ({layer.weight_bytes} B unique)")
    return MappedModel(spec=spec, layers=layers, lif=lif,
                       weight_dict=weight_dict, compression=compression)


@dataclasses.dataclass
class RunResult:
    out_spikes: np.ndarray                 # [T, n_out]
    per_layer_stats: list[DispatchStats]
    per_layer_util: list[np.ndarray]       # MEM_S&N utilization per step
    energy: EnergyReport
    overflow: list[np.ndarray] = dataclasses.field(default_factory=list)
    # events dropped by the finite MEM_E depth, per layer per step (all
    # zeros when run() was not given ``max_events``)


def lif_rollout_np(currents: np.ndarray, p: LIFParams) -> np.ndarray:
    """Discrete-time LIF over ``currents[T, n]`` (numpy, cycle-accurate twin
    semantics): integrate, compare, hard-reset.  Shared by :func:`run`,
    :func:`reference_forward`, and the batched engine's oracle tests."""
    v = np.zeros(currents.shape[1:], dtype=np.float32)
    out = np.zeros_like(currents)
    for t in range(currents.shape[0]):
        v = p.beta * v + currents[t]
        fired = v >= p.threshold
        out[t] = fired.astype(np.float32)
        v = np.where(fired, p.v_reset, v)
    return out


def run(model: MappedModel, in_spikes: np.ndarray,
        sn_capacity_rows: int | None = None,
        frame_cycles: int | None = FRAME_CYCLES,
        max_events: int | None = None) -> RunResult:
    """Execute a spike train [T, n_in] through the MX-NEURACORE chain.
    Rounds within a layer execute sequentially (their cycles add); their
    currents target disjoint neuron subsets.

    ``frame_cycles`` has :func:`repro_torch.core.energy.energy_model`'s signature:
    it defaults to the calibrated sensor frame period and ``None`` selects
    throughput mode (no idle between frames).

    ``max_events`` caps the per-step MEM_E FIFO depth on every core:
    excess events are dropped lowest-priority-last (ascending source index
    kept first) *before* dispatch, so the loss propagates through the LIF
    into every downstream layer — the same semantics as
    ``run_batched(max_events=...)``, tested equivalent.
    """
    p = model.lif
    spikes = np.asarray(in_spikes, dtype=np.float32)
    stats_all, util_all, drop_all = [], [], []
    for layer in model.layers:
        t_steps = spikes.shape[0]
        currents = np.zeros((t_steps, layer.n_dest), dtype=np.float32)
        agg_stats = None
        total_rows = sum(r.tables.n_rows for r in layer.rounds)
        util = np.zeros(t_steps)
        for rnd in layer.rounds:
            cur_sub, stats = dispatch_simulate(rnd.tables, spikes,
                                               len(rnd.neuron_ids),
                                               max_events=max_events)
            assigned = rnd.mapping.engine >= 0
            currents[:, rnd.neuron_ids[assigned]] += cur_sub[:, assigned]
            agg_stats = stats if agg_stats is None else agg_stats.merge_round(stats)
            cap_rows = sn_capacity_rows or max(total_rows, 1)
            util += mem_sn_utilization(rnd.tables, spikes, cap_rows,
                                       max_events=max_events)
        arrivals = (spikes > 0).sum(axis=1).astype(np.int64)
        depth = arrivals.max(initial=0) if max_events is None else max_events
        drop_all.append(np.maximum(arrivals - depth, 0))
        # discrete-time LIF over the layer's neurons
        out = lif_rollout_np(currents, p)
        util_all.append(util)
        stats_all.append(agg_stats)
        spikes = out
    energy = energy_model(model.spec, stats_all, frame_cycles=frame_cycles,
                          per_core_bits=[l.bits for l in model.layers])
    return RunResult(out_spikes=spikes, per_layer_stats=stats_all,
                     per_layer_util=util_all, energy=energy,
                     overflow=drop_all)


def run_batch(model: MappedModel, in_spikes: np.ndarray,
              sn_capacity_rows: int | None = None,
              frame_cycles: int | None = FRAME_CYCLES,
              max_events: int | None = None) -> list[RunResult]:
    """Batched oracle: :func:`run` over ``in_spikes[B, T, n_in]``, one
    :class:`RunResult` per sample.  Still the per-sample cycle-accurate
    Python walk — this is the reference the equivalence suites compare the
    batched engine against, not a fast path."""
    spikes = np.asarray(in_spikes, dtype=np.float32)
    if spikes.ndim != 3:
        raise ValueError(f"expected [B, T, n_in], got {spikes.shape}")
    return [run(model, spikes[b], sn_capacity_rows=sn_capacity_rows,
                frame_cycles=frame_cycles, max_events=max_events)
            for b in range(spikes.shape[0])]


def reference_forward(weights: "list[np.ndarray | LayerSpec]", lif: LIFParams,
                      in_spikes: np.ndarray) -> np.ndarray:
    """Pure dense reference: same math, no event machinery (the oracle).
    Accepts the same layer specs as :func:`map_model` — conv layers execute
    as their unrolled synaptic matrices."""
    spikes = np.asarray(in_spikes, dtype=np.float32)
    for layer in weights:
        w = as_layer_spec(layer).unroll()
        currents = spikes @ np.asarray(w, dtype=np.float32)
        spikes = lif_rollout_np(currents, lif)
    return spikes
