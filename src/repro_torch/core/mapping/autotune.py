"""Engine-grid autotuner: pick the ``(M, N)`` core geometry for a model.

MENAGE's per-core grid — M A-NEURON engines x N capacitors each — is a free
design parameter the paper fixes per accelerator instance (§IV-A: 10x16 for
Accel_1, 20x32 for Accel_2).  For a *given* model the fixed grid is rarely
the best use of the M*N capacity: a wide shallow layer wants more engines
(rows carry more synapses each, fewer MEM_S&N rows dispatched per event),
a narrow deep chain wants more capacitors per engine (fewer
capacitor-reassignment rounds).  Restructurable neuromorphic fabrics exploit
exactly this degree of freedom (cf. SpikeHard's 64x64 -> 32x32 core
restructuring, arXiv:2306.15749; bottleneck-driven resizing in
arXiv:2511.21549).

:func:`autotune_grid` re-solves
:func:`repro_torch.core.accelerator.map_model` over candidate grid shapes
of the same total capacity M*N, scores every feasible mapping with a
roofline-style dispatch-cost model (:func:`estimate_cycles`), and returns
the best mapping plus the full scoreboard.  The score is lexicographic
``(rounds_per_timestep, est_cycles, sram_bytes)`` and the default grid is
always a candidate, so the winner NEVER regresses rounds-per-timestep
against the untuned spec — at equal rounds it must beat (or tie) the
estimated dispatch cycles.

The cost model mirrors :func:`repro_torch.core.memories.dispatch_simulate`'s
accounting: the controller spends ``max(B_i, 1)`` cycles per event of source
``i`` (serial MEM_S&N row reads; the M engines fire in parallel *within* a
row), so per time step the expected dispatch cost at source activity ``p``
is ``p * sum_i max(B_i, 1)`` summed over a layer's rounds, plus a
capacitor-reassignment overhead of ``N`` cycles per extra round.  The MAC
roofline ``p * nnz / M`` is folded in via ``max`` — it can only bind for
hypothetical engines slower than one synapse per row slot, but it keeps the
estimate honest if row packing ever changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mapping.ilp import MappingError


@dataclasses.dataclass(frozen=True)
class GridScore:
    """One candidate grid's scoreboard entry."""

    n_engines: int
    n_caps: int
    feasible: bool
    rounds_per_timestep: int = 0    # total rounds across the layer chain
    est_cycles: float = 0.0         # roofline dispatch cycles per timestep
    sram_bytes: int = 0             # max per-layer A-SYN bytes allocated
    reason: str = ""                # why infeasible (MappingError text)

    @property
    def key(self) -> tuple:
        """Lexicographic comparison key — smaller is better."""
        return (not self.feasible, self.rounds_per_timestep,
                self.est_cycles, self.sram_bytes)

    def as_dict(self) -> dict:
        return {"n_engines": self.n_engines, "n_caps": self.n_caps,
                "feasible": self.feasible,
                "rounds_per_timestep": self.rounds_per_timestep,
                "est_cycles": self.est_cycles,
                "sram_bytes": self.sram_bytes, "reason": self.reason}


@dataclasses.dataclass
class AutotuneResult:
    """Best mapping + the full scoreboard (sorted best-first)."""

    model: "object"                 # MappedModel on the winning grid
    spec: "object"                  # AcceleratorSpec actually used
    best: GridScore
    default: GridScore              # the untuned spec's entry
    scores: list[GridScore]

    @property
    def tuned(self) -> bool:
        """True when the winner differs from the default grid."""
        return (self.best.n_engines, self.best.n_caps) != \
            (self.default.n_engines, self.default.n_caps)


def candidate_grids(spec, max_candidates: int = 8) -> list[tuple[int, int]]:
    """Candidate ``(M, N)`` shapes: divisor factor pairs of the default
    capacity ``M0*N0``, nearest-to-default first, default always included.
    Degenerate shapes (single engine / single capacitor) are excluded —
    they break the event-driven parallelism the core exists for."""
    m0, n0 = spec.n_engines, spec.n_caps
    cap = m0 * n0
    pairs = {(m0, n0)}
    for m in range(2, cap // 2 + 1):
        if cap % m == 0:
            pairs.add((m, cap // m))
    ordered = sorted(pairs, key=lambda p: (abs(np.log2(p[0] / m0)), p[0]))
    keep = ordered[:max_candidates]
    if (m0, n0) not in keep:        # max_candidates too small to reach it
        keep = [(m0, n0)] + keep[:max_candidates - 1]
    return keep


def estimate_cycles(model, activity: float = 0.1) -> float:
    """Roofline dispatch-cost estimate, in controller cycles per timestep,
    for a mapped model at uniform source-spike probability ``activity``.

    Per round: ``max(p * sum_i max(B_i, 1),  p * nnz / M)`` — serial row
    dispatch vs. parallel engine MACs — plus ``N`` reassignment cycles per
    round after the first.  Layers run on separate chained cores, so the
    chain cost is the max over layers (pipeline bottleneck), not the sum.
    """
    worst = 0.0
    for layer in model.layers:
        cost = 0.0
        for ri, rnd in enumerate(layer.rounds):
            tb = rnd.tables
            rows = float(np.maximum(tb.e2a_count, 1).sum())
            macs = float(tb.sn_valid.sum())
            cost += max(activity * rows, activity * macs / tb.n_engines)
            if ri > 0:
                cost += tb.n_caps          # capacitor reassignment
        worst = max(worst, cost)
    return worst


def autotune_grid(weights, spec, *, activity: float = 0.1,
                  max_candidates: int = 8, candidates=None,
                  **map_kwargs) -> AutotuneResult:
    """Search candidate engine grids for the best mapping of ``weights``.

    ``weights`` / ``**map_kwargs`` are passed straight to
    :func:`repro_torch.core.accelerator.map_model` (so ``compress=True``,
    ``quant_bits``, ``fanout``, ``method`` all compose with the search).
    Candidates default to :func:`candidate_grids`; pass ``candidates`` to
    pin an explicit ``[(m, n), ...]`` list (the default grid is appended if
    missing, preserving the no-regression guarantee).

    Raises :class:`~repro_torch.core.mapping.ilp.MappingError` only when
    EVERY candidate — including the default — is infeasible.
    """
    from repro_torch.core.accelerator import map_model  # circular at import

    default_mn = (spec.n_engines, spec.n_caps)
    grids = list(candidates) if candidates is not None else \
        candidate_grids(spec, max_candidates=max_candidates)
    grids = [(int(m), int(n)) for m, n in grids]
    if default_mn not in grids:
        grids.append(default_mn)

    scores: list[GridScore] = []
    mapped: dict[tuple[int, int], tuple] = {}
    for m, n in grids:
        cand = dataclasses.replace(spec, n_engines=m, n_caps=n,
                                   name=f"{spec.name}[{m}x{n}]")
        try:
            model = map_model(weights, cand, **map_kwargs)
        except (MappingError, ValueError) as e:
            scores.append(GridScore(n_engines=m, n_caps=n, feasible=False,
                                    reason=str(e)))
            continue
        score = GridScore(
            n_engines=m, n_caps=n, feasible=True,
            rounds_per_timestep=sum(len(l.rounds) for l in model.layers),
            est_cycles=estimate_cycles(model, activity=activity),
            sram_bytes=max(l.sram_bytes for l in model.layers))
        scores.append(score)
        mapped[(m, n)] = (model, cand)

    scores.sort(key=lambda s: s.key)
    default_score = next(s for s in scores
                         if (s.n_engines, s.n_caps) == default_mn)
    best = scores[0]
    if not best.feasible:
        raise MappingError(
            f"autotune_grid: no feasible grid among {grids} for "
            f"{spec.name}: {best.reason}")
    model, cand = mapped[(best.n_engines, best.n_caps)]
    return AutotuneResult(model=model, spec=cand, best=best,
                          default=default_score, scores=scores)
