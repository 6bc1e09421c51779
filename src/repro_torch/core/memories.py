"""Memory-based event control (paper §III-C, Fig. 4).

Per MX-NEURACORE, three memories steer each received event (a source-neuron
index) to the right A-SYN / A-NEURON engines:

  MEM_E    — event FIFO; each entry is a source-neuron index N_i.
  MEM_E2A  — row per source neuron: (B_i, A_i) = (#rows in MEM_S&N for N_i,
             start address of those rows).
  MEM_S&N  — row = one dispatch *cycle* worth of work: for each of the M
             A-NEURON engines, (NI_j valid bit, virtual-neuron index k_j of
             width log2(N), weight address into the A-SYN SRAM).  A source
             connected to more destinations than one row can carry (at most
             one per engine per cycle — each engine integrates one synapse
             per clock) occupies B_i consecutive rows.

The ILP mapping determines which engine/capacitor serves each destination
neuron; the row count B_i for source i is therefore
``max_j |{dest of i assigned to engine j}|`` — the ILP's load-balancing
directly minimizes dispatch cycles.

``dispatch_simulate`` is the cycle-level model: it reproduces the paper's
MEM_S&N-utilization-vs-time-step curves (Figs 6-7), counts controller cycles
and engine operations for the energy model, and — crucially — is proven
equivalent to the dense reference computation (spikes @ W) in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mapping.ilp import MappingSolution


@dataclasses.dataclass
class MemTables:
    """Bit-level content of the three control memories + A-SYN weight SRAM."""

    # MEM_E2A: per source neuron
    e2a_count: np.ndarray   # B_i  — rows in MEM_S&N
    e2a_addr: np.ndarray    # A_i  — start row
    # MEM_S&N: R rows x M engines
    sn_valid: np.ndarray    # bool [R, M]   — NI_j
    sn_virt: np.ndarray     # int  [R, M]   — virtual-neuron (capacitor) index
    sn_waddr: np.ndarray    # int  [R, M]   — weight address in A-SYN SRAM
    # A-SYN weight SRAM (per engine, addressed by sn_waddr)
    weight_mem: np.ndarray  # f32  [M, W]
    # bookkeeping
    n_engines: int
    n_caps: int
    mapping: MappingSolution
    n_weight_words: int = 0  # A-SYN words actually allocated (across engines);
                             # after compress_weight_words: words this table
                             # newly contributes to the shared dictionary
    word_bits: int = 8       # stored A-SYN word width (sign-magnitude C2C
                             # ladder words; 2/4/8) — prices SRAM bytes
    # physical per-engine word slots (len of each engine's allocation;
    # invariant under cross-layer compression — pointer-table entries)
    engine_words: np.ndarray | None = None          # int [M]
    # cross-round/cross-layer synapse compression (arXiv:2112.07019):
    # weight_ptr[j, a] indexes the model-shared weight_dict; set by
    # compress_weight_words, and always satisfies
    # weight_mem[j, a] == weight_dict[weight_ptr[j, a]] on allocated slots
    weight_ptr: np.ndarray | None = None            # i32 [M, W]
    weight_dict: np.ndarray | None = None           # f32 [K], shared object

    @property
    def n_rows(self) -> int:
        return self.sn_valid.shape[0]

    def bits_per_row(self) -> int:
        """Row width per Fig. 4: M valid bits + M*log2(N) virtual indices +
        M*ceil(log2(W)) weight addresses."""
        m = self.n_engines
        virt_bits = max(int(np.ceil(np.log2(max(self.n_caps, 2)))), 1)
        waddr_bits = max(int(np.ceil(np.log2(max(self.weight_mem.shape[1], 2)))), 1)
        return m * (1 + virt_bits + waddr_bits)

    def inverse_map(self) -> np.ndarray:
        """(engine, capacitor) -> destination-neuron index (-1 = free)."""
        sol = self.mapping
        inv = -np.ones((self.n_engines, self.n_caps), dtype=np.int64)
        for i in range(len(sol.engine)):
            if sol.engine[i] >= 0:
                inv[sol.engine[i], sol.capacitor[i]] = i
        return inv

    def dense_weights(self, n_dest: int) -> np.ndarray:
        """Replay the tables into a dense ``[n_src, n_dest]`` matrix: the
        effective synaptic weight each source event deposits on each assigned
        destination.  This is what the batched engine executes — derived from
        the memory *content*, not from the original weight matrix, so table
        corruption shows up as an equivalence failure.

        Vectorised over the :meth:`replay_coo` walk (source-ordered
        contiguous rows, as :func:`build_event_memories` lays them out).
        Each (src, dest) pair occurs once, so the result equals the
        reference's per-row Python replay bit for bit (tested)."""
        w = np.zeros((len(self.e2a_count), n_dest), dtype=np.float32)
        src, dest, vals = self.replay_coo()
        np.add.at(w, (src, dest), vals)
        return w

    def _replay_indices(self):
        """Shared COO replay walk: ``(src, dest_local, engine, waddr)`` per
        stored synapse, in :meth:`dense_weights` accumulation order."""
        used = self.e2a_count.sum()
        if used == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z, z
        # build_event_memories lays rows out contiguously in source order
        starts = np.concatenate([[0], np.cumsum(self.e2a_count)[:-1]])
        if not (self.e2a_addr == starts).all():
            raise ValueError(
                "replay_coo requires source-ordered contiguous MEM_S&N rows")
        row_src = np.repeat(np.arange(len(self.e2a_count)), self.e2a_count)
        rr, jj = np.nonzero(self.sn_valid[: len(row_src)])
        inv = self.inverse_map()
        dest = inv[jj, self.sn_virt[rr, jj]]
        return row_src[rr], dest, jj, self.sn_waddr[rr, jj]

    def replay_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Replay the tables into COO triplets ``(src, dest_local, weight)``
        — one per stored synapse — in :meth:`dense_weights` accumulation
        order.  O(rows x engines) work and memory: for shared-weight (conv)
        layers this is the replay path that never materializes the
        ``n_src x n_dest`` dense matrix.  Like ``dense_weights`` it is
        derived from the memory *content*, so table corruption still shows
        up as an equivalence failure."""
        src, dest, jj, waddr = self._replay_indices()
        vals = self.weight_mem[jj, waddr]
        return src, dest, vals.astype(np.float32)

    def replay_coo_ptr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`replay_coo` through the compression indirection:
        ``(src, dest_local, widx)`` where ``widx`` indexes the model-shared
        :attr:`weight_dict` — ``weight_dict[widx]`` equals
        ``replay_coo()``'s values bit for bit.  The engine gathers the
        dictionary on device under jit (see
        :func:`repro_torch.engine.batched_run.pack_model`)."""
        if self.weight_ptr is None:
            raise ValueError("tables are not compressed: run "
                             "compress_weight_words first")
        src, dest, jj, waddr = self._replay_indices()
        return src, dest, self.weight_ptr[jj, waddr].astype(np.int64)

    def alloc_words(self) -> np.ndarray:
        """Per-engine allocated A-SYN word-slot counts: recorded by
        :func:`build_event_memories`; derived from the referenced addresses
        for hand-built tables."""
        if self.engine_words is not None:
            return np.asarray(self.engine_words, dtype=np.int64)
        counts = np.zeros(self.n_engines, dtype=np.int64)
        rr, jj = np.nonzero(self.sn_valid)
        np.maximum.at(counts, jj, self.sn_waddr[rr, jj] + 1)
        return counts

    def to_torch(self, device: "torch.device | str",
                 pad_src: int | None = None,
                 pad_rows: int | None = None) -> "PackedTables":
        """Pack the three control memories into padded int32 tensors on
        ``device``.

        ``pad_src`` / ``pad_rows`` extend MEM_E2A / MEM_S&N to a static size
        so tables from different rounds or layers can be stacked; padding
        sources have B_i = 0 and padding rows have no valid entries.  The
        per-source stats vectors are computed here, from the host copy, so
        no device-to-host pull ever happens per run.
        """
        s = len(self.e2a_count) if pad_src is None else int(pad_src)
        r = self.n_rows if pad_rows is None else int(pad_rows)
        if s < len(self.e2a_count) or r < self.n_rows:
            raise ValueError(f"padding ({s}, {r}) is smaller than the "
                             f"tables ({len(self.e2a_count)}, {self.n_rows})")

        def pad1(x, n):
            return np.pad(np.asarray(x, dtype=np.int32), (0, n - len(x)))

        def pad2(x, n):
            x = np.asarray(x, dtype=np.int32)
            return np.pad(x, ((0, n - x.shape[0]), (0, 0)))

        host = dict(e2a_count=pad1(self.e2a_count, s),
                    e2a_addr=pad1(self.e2a_addr, s),
                    sn_valid=pad2(self.sn_valid, r),
                    sn_virt=pad2(self.sn_virt, r),
                    sn_waddr=pad2(self.sn_waddr, r))
        return PackedTables(
            **{k: torch.from_numpy(v).to(device) for k, v in host.items()},
            weight_mem=torch.from_numpy(
                np.ascontiguousarray(self.weight_mem, dtype=np.float32)
            ).to(device),
            n_engines=self.n_engines,
            n_caps=self.n_caps,
            n_rows=self.n_rows,
            row_bits=self.bits_per_row(),
            stats=stats_vectors(host["e2a_count"], host["e2a_addr"],
                                 host["sn_valid"]),
        )


def stats_vectors(e2a_count: np.ndarray, e2a_addr: np.ndarray,
                   sn_valid: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-source (rows, cycles, MACs) contributed by one event."""
    count = np.asarray(e2a_count, dtype=np.int64)
    addr = np.asarray(e2a_addr, dtype=np.int64)
    row_ops = np.asarray(sn_valid, dtype=np.int64).sum(axis=1)
    cum = np.concatenate([[0], np.cumsum(row_ops)])
    ops = cum[addr + count] - cum[addr]
    return count, np.maximum(count, 1), ops


@dataclasses.dataclass
class PackedTables:
    """:class:`MemTables` as padded int32 tensors on one device, plus the
    static geometry and the host-side per-source stats vectors."""

    e2a_count: torch.Tensor    # i32 [S_pad]
    e2a_addr: torch.Tensor     # i32 [S_pad]
    sn_valid: torch.Tensor     # i32 [R_pad, M] (0/1)
    sn_virt: torch.Tensor      # i32 [R_pad, M]
    sn_waddr: torch.Tensor     # i32 [R_pad, M]
    weight_mem: torch.Tensor   # f32 [M, W]
    n_engines: int = 0
    n_caps: int = 0
    n_rows: int = 0
    row_bits: int = 0
    stats: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    @property
    def row_bytes(self) -> int:
        return (self.row_bits + 7) // 8

    def stats_vectors(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-source (rows, cycles, MACs) contributed by one event — the
        dot-product vectors behind the batched :class:`DispatchStats`, kept
        on the host since packing."""
        return self.stats


def build_event_memories(w: np.ndarray, sol: MappingSolution,
                         n_engines: int, n_caps: int,
                         share_ids: np.ndarray | None = None,
                         dedup: bool = False,
                         word_bits: int = 8) -> MemTables:
    """Construct MEM_E2A / MEM_S&N / weight SRAM from a pruned weight matrix
    ``w[n_src, n_dest]`` and an ILP mapping solution.

    ``share_ids`` (int64 ``[n_src, n_dest]``, -1 = no synapse) enables the
    shared-weight indirection used for convolutions: synapses carrying the
    same id within one engine point their MEM_S&N weight address at a single
    A-SYN SRAM word (one stored kernel tap, many rows reading it), instead
    of each synapse allocating its own word.  ``None`` keeps the dense
    layout: one SRAM word per synapse, bit-identical to the pre-conv path.

    ``dedup`` generalizes the sharing from taps to *values* (the synapse
    compression of arXiv:2112.07019): any two synapses on the same engine
    whose quantized words are bit-identical share one A-SYN word, whatever
    layer structure produced them.  Replay is unchanged bit for bit — the
    merged words are exactly equal — while ``n_weight_words`` (and the
    weight-address field width, hence MEM_S&N row bytes) shrinks.

    ``word_bits`` records the stored word width (the layer's quantization
    bit-width) so downstream SRAM accounting prices words at their actual
    size instead of a fixed byte.
    """
    n_src, n_dest = w.shape
    e2a_count = np.zeros(n_src, dtype=np.int64)
    e2a_addr = np.zeros(n_src, dtype=np.int64)
    rows_valid, rows_virt, rows_waddr = [], [], []
    # per-engine weight SRAM allocation (next free address per engine)
    w_next = np.zeros(n_engines, dtype=np.int64)
    w_entries: list[list[float]] = [[] for _ in range(n_engines)]
    # per-engine share-id -> allocated SRAM address
    shared_addr: list[dict[int, int]] = [{} for _ in range(n_engines)]
    # per-engine quantized word value -> allocated SRAM address (dedup)
    value_addr: list[dict[float, int]] = [{} for _ in range(n_engines)]

    def alloc(j: int, m: int, i: int) -> int:
        """SRAM address in engine j for synapse (m, i): fresh word unless
        the synapse's share id — or, under ``dedup``, its exact quantized
        value — already has one on this engine."""
        v = float(w[m, i])
        sid = -1 if share_ids is None else int(share_ids[m, i])
        if sid >= 0 and sid in shared_addr[j]:
            addr = shared_addr[j][sid]
            if w_entries[j][addr] != v:
                raise ValueError(
                    f"share id {sid} maps to conflicting weight values "
                    f"({w_entries[j][addr]} vs {v}) on engine {j}")
            return addr
        if dedup and v in value_addr[j]:
            addr = value_addr[j][v]
            if sid >= 0:
                shared_addr[j][sid] = addr
            return addr
        addr = int(w_next[j])
        w_entries[j].append(v)
        w_next[j] += 1
        if sid >= 0:
            shared_addr[j][sid] = addr
        if dedup:
            value_addr[j][v] = addr
        return addr

    for m in range(n_src):
        dests = np.nonzero(w[m])[0]
        dests = dests[sol.engine[dests] >= 0]          # unassigned are dropped
        # group by engine; B_m = max per-engine count
        per_engine: list[list[int]] = [[] for _ in range(n_engines)]
        for i in dests:
            per_engine[sol.engine[i]].append(int(i))
        b = max((len(g) for g in per_engine), default=0)
        e2a_addr[m] = len(rows_valid)
        e2a_count[m] = b
        for r in range(b):
            valid = np.zeros(n_engines, dtype=bool)
            virt = np.zeros(n_engines, dtype=np.int64)
            waddr = np.zeros(n_engines, dtype=np.int64)
            for j in range(n_engines):
                if r < len(per_engine[j]):
                    i = per_engine[j][r]
                    valid[j] = True
                    virt[j] = sol.capacitor[i]
                    waddr[j] = alloc(j, m, i)
            rows_valid.append(valid)
            rows_virt.append(virt)
            rows_waddr.append(waddr)

    wmax = max(int(w_next.max()), 1)
    weight_mem = np.zeros((n_engines, wmax), dtype=np.float32)
    for j in range(n_engines):
        if w_entries[j]:
            weight_mem[j, : len(w_entries[j])] = np.array(w_entries[j], dtype=np.float32)

    r = max(len(rows_valid), 1)
    return MemTables(
        e2a_count=e2a_count,
        e2a_addr=e2a_addr,
        sn_valid=np.array(rows_valid, dtype=bool).reshape(r if rows_valid else 1, n_engines) if rows_valid else np.zeros((1, n_engines), dtype=bool),
        sn_virt=np.array(rows_virt, dtype=np.int64).reshape(-1, n_engines) if rows_virt else np.zeros((1, n_engines), dtype=np.int64),
        sn_waddr=np.array(rows_waddr, dtype=np.int64).reshape(-1, n_engines) if rows_waddr else np.zeros((1, n_engines), dtype=np.int64),
        weight_mem=weight_mem,
        n_engines=n_engines,
        n_caps=n_caps,
        mapping=sol,
        n_weight_words=int(sum(len(e) for e in w_entries)),
        engine_words=w_next.copy(),
        word_bits=int(word_bits),
    )


@dataclasses.dataclass(frozen=True)
class WeightCompression:
    """Accounting for the shared-dictionary synapse compression
    (arXiv:2112.07019 applied to the A-SYN SRAM).

    Physical model: each engine's A-SYN becomes a *pointer table* (one
    ``ptr_bits``-wide entry per allocated word slot) into a single
    chip-shared dictionary of unique quantized words.  Three allocation
    levels are reported:

      synapse_words — one word per stored synapse (no sharing at all; what
                      the dense pre-conv layout allocates)
      slot_words    — per-engine slots after tap/value dedup (= pointer
                      entries; ``build_event_memories`` allocation)
      dict_words    — unique words K in the cross-round/cross-layer shared
                      dictionary
    """

    synapse_words: int
    slot_words: int
    dict_words: int
    ptr_bits: int
    # total bits of the dictionary payload: each unique word is priced at the
    # widest word_bits of the tables that reference it (0 = legacy 8-bit)
    dict_bits_total: int = 0

    @property
    def dict_bytes(self) -> int:
        """Dictionary payload bytes at the stored word widths (legacy
        tables without ``dict_bits_total``: 8-bit words -> 1 byte each)."""
        bits = self.dict_bits_total or self.dict_words * 8
        return (bits + 7) // 8

    @property
    def ptr_bytes(self) -> int:
        return (self.slot_words * self.ptr_bits + 7) // 8

    @property
    def compressed_bytes(self) -> int:
        return self.dict_bytes + self.ptr_bytes

    @property
    def ratio(self) -> float:
        """Word-count compression vs the per-synapse layout."""
        return self.synapse_words / max(self.dict_words, 1)

    def as_dict(self) -> dict:
        return {"synapse_words": self.synapse_words,
                "slot_words": self.slot_words,
                "dict_words": self.dict_words,
                "ptr_bits": self.ptr_bits,
                "dict_bits_total": self.dict_bits_total,
                "dict_bytes": self.dict_bytes,
                "ptr_bytes": self.ptr_bytes,
                "compressed_bytes": self.compressed_bytes,
                "ratio": self.ratio}


def compress_weight_words(tables: "list[MemTables]") -> WeightCompression:
    """Deduplicate identical quantized A-SYN words across engines, rounds,
    and layers behind one shared dictionary.

    Walks the given tables in order (map_model passes every round of every
    layer), assigns each distinct word value a dictionary index at first
    sight, and attaches to each table: ``weight_ptr`` (the per-slot
    indirection) and the shared ``weight_dict`` array.  Each table's
    ``n_weight_words`` becomes the number of words it *newly* contributes —
    so ``sum(n_weight_words) == dict_words`` across the model and a layer
    whose words all appeared earlier in the chain costs zero new words.

    Replay stays bit-exact by construction: ``weight_dict[weight_ptr]``
    reproduces ``weight_mem`` on every allocated slot (tested), and no
    MEM_S&N content changes — only the accounting and the engine's replay
    route (:meth:`MemTables.replay_coo_ptr`) go through the indirection.
    """
    index: dict[float, int] = {}
    values: list[float] = []
    value_bits: list[int] = []
    synapse_words = 0
    slot_words = 0
    new_counts: list[int] = []
    ptrs: list[np.ndarray] = []
    for tb in tables:
        words = tb.alloc_words()
        synapse_words += int(tb.sn_valid.sum())
        slot_words += int(words.sum())
        new = 0
        ptr = np.zeros(tb.weight_mem.shape, dtype=np.int32)
        for j in range(tb.n_engines):
            for a in range(int(words[j])):
                v = float(tb.weight_mem[j, a])
                idx = index.get(v)
                if idx is None:
                    idx = len(values)
                    index[v] = idx
                    values.append(v)
                    value_bits.append(tb.word_bits)
                    new += 1
                else:
                    # a shared word must be readable at the widest precision
                    # any referencing table stores it at
                    value_bits[idx] = max(value_bits[idx], tb.word_bits)
                ptr[j, a] = idx
        new_counts.append(new)
        ptrs.append(ptr)
    weight_dict = np.asarray(values, dtype=np.float32)
    for tb, ptr, new in zip(tables, ptrs, new_counts):
        tb.weight_ptr = ptr
        tb.weight_dict = weight_dict
        tb.n_weight_words = new
    k = max(len(values), 1)
    return WeightCompression(
        synapse_words=synapse_words, slot_words=slot_words,
        dict_words=len(values),
        ptr_bits=max(int(np.ceil(np.log2(max(k, 2)))), 1),
        dict_bits_total=int(sum(value_bits)))


@dataclasses.dataclass
class DispatchStats:
    """Per-time-step statistics from the cycle-level simulator."""

    cycles: np.ndarray          # controller cycles spent dispatching, per step
    rows_touched: np.ndarray    # MEM_S&N rows read, per step (Figs 6-7 signal)
    engine_ops: np.ndarray      # synaptic MACs executed, per step
    events: np.ndarray          # events received, per step
    sn_bytes_touched: np.ndarray  # bytes of MEM_S&N traffic per step
    mem_e_peak: int             # peak MEM_E occupancy observed

    @property
    def total_ops(self) -> int:
        # 1 MAC = 2 ops (mul + add), the TOPS convention used by Table II
        return int(self.engine_ops.sum()) * 2

    @property
    def total_cycles(self) -> int:
        return int(self.cycles.sum())

    def merge_round(self, other: "DispatchStats") -> "DispatchStats":
        """Combine stats of two rounds of the same layer: their dispatch
        cycles/rows/ops add (rounds run sequentially) while the event stream
        is shared, so ``events`` stays and MEM_E peaks take the max."""
        return DispatchStats(
            cycles=self.cycles + other.cycles,
            rows_touched=self.rows_touched + other.rows_touched,
            engine_ops=self.engine_ops + other.engine_ops,
            events=self.events,
            sn_bytes_touched=self.sn_bytes_touched + other.sn_bytes_touched,
            mem_e_peak=max(self.mem_e_peak, other.mem_e_peak))


def dispatch_simulate(tables: MemTables, spikes: np.ndarray,
                      n_dest: int,
                      max_events: int | None = None
                      ) -> tuple[np.ndarray, DispatchStats]:
    """Cycle-level event dispatch for a spike train ``spikes[T, n_src]``.

    Returns ``(currents[T, n_dest], stats)`` where ``currents[t, i]`` is the
    synaptic current accumulated into destination neuron i at step t — must
    equal ``spikes[t] @ W`` restricted to assigned neurons (tested).

    ``max_events`` models a finite MEM_E FIFO depth: at most that many
    events are accepted per step, lowest source index first (hardware FIFO
    write order), the rest are dropped before dispatch.  ``stats.events``
    still counts *arrivals*; dispatch work (cycles / rows / MACs / bytes)
    and ``mem_e_peak`` reflect only accepted events — matching the batched
    engine's ``events_from_spikes`` truncation exactly.
    """
    t_steps, n_src = spikes.shape
    currents = np.zeros((t_steps, n_dest), dtype=np.float32)
    cycles = np.zeros(t_steps, dtype=np.int64)
    rows_touched = np.zeros(t_steps, dtype=np.int64)
    engine_ops = np.zeros(t_steps, dtype=np.int64)
    events = np.zeros(t_steps, dtype=np.int64)
    bytes_touched = np.zeros(t_steps, dtype=np.int64)
    row_bytes = (tables.bits_per_row() + 7) // 8
    inv = tables.inverse_map()
    mem_e_peak = 0
    for t in range(t_steps):
        src_idx = np.nonzero(spikes[t])[0]
        events[t] = len(src_idx)
        if max_events is not None:
            src_idx = src_idx[:max_events]
        mem_e_peak = max(mem_e_peak, len(src_idx))
        for m in src_idx:
            b, a = int(tables.e2a_count[m]), int(tables.e2a_addr[m])
            cycles[t] += max(b, 1)  # >=1 cycle to poll MEM_E + read MEM_E2A
            rows_touched[t] += b
            bytes_touched[t] += b * row_bytes
            for r in range(a, a + b):
                valid = tables.sn_valid[r]
                for j in np.nonzero(valid)[0]:
                    k = int(tables.sn_virt[r, j])
                    i = int(inv[j, k])
                    wv = tables.weight_mem[j, int(tables.sn_waddr[r, j])]
                    currents[t, i] += wv
                    engine_ops[t] += 1
    stats = DispatchStats(cycles=cycles, rows_touched=rows_touched,
                          engine_ops=engine_ops, events=events,
                          sn_bytes_touched=bytes_touched, mem_e_peak=mem_e_peak)
    return currents, stats


def mem_sn_utilization(tables: MemTables, spikes: np.ndarray,
                       capacity_rows: int,
                       max_events: int | None = None) -> np.ndarray:
    """Fraction of MEM_S&N rows active per time step (Figs 6-7): rows
    belonging to neurons that spiked at step t over total row capacity.
    ``max_events`` applies the same MEM_E acceptance cap as
    :func:`dispatch_simulate` — dropped events touch no rows."""
    t_steps = spikes.shape[0]
    util = np.zeros(t_steps, dtype=np.float64)
    for t in range(t_steps):
        src_idx = np.nonzero(spikes[t])[0]
        if max_events is not None:
            src_idx = src_idx[:max_events]
        util[t] = tables.e2a_count[src_idx].sum() / max(capacity_rows, 1)
    return util
