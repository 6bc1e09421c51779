"""Per-layer weight bit-width search (mixed-precision operand path).

MENAGE's C2C-ladder MAC switches one ladder capacitor + SRAM bitline per
magnitude bit, so both the A-SYN footprint and the per-MAC energy scale
~linearly with the stored word width (see :func:`repro_torch.core.energy.
energy_model`).  Dropping a layer from 8 to 4 bits halves its weight SRAM
and nearly halves its MAC energy — *if* the model still computes the same
thing.  This module finds, per layer, the narrowest supported width that
keeps the accelerator's output within an accuracy budget of the 8-bit
baseline.

The search is greedy and descends from 8 bits:

  1. Map + run the all-8-bit model on a probe spike train — the baseline
     output and the per-core dispatch statistics that price energy.
  2. Sensitivity probe: for each layer alone, drop it to the widest sub-8
     choice and measure output agreement against the baseline.  Layers are
     then visited least-sensitive first.
  3. For each layer in that order, walk the sub-8 choices downward and keep
     the narrowest width whose *whole-config* agreement stays at or above
     ``1 - budget``.  Every candidate is a real ``map_model`` + ``run`` —
     requantization changes which small weights collapse to zero, so the
     probe executes the config it scores, not an approximation.

Every step is scored by the analytical energy model (the acceptance
criterion is accuracy; energy strictly decreases with bits for fixed
dispatch work, which is what makes greedy descent safe).  Layer specs with
a pinned ``bits`` field are left untouched — the pin wins over the search,
exactly as it wins over ``map_model(quant_bits=...)``.

``PARETO_POINT_KEYS`` is the shared schema for accuracy/energy/throughput
Pareto points, the reference package's own (``docs/PRECISION.md``
documents it).  ``chip_smoke.py`` prints one per width configuration, with
``events_per_s`` measured on the card.

The search runs on the host: the port's ``map_model`` and its numpy oracle
``run`` score every candidate, in the reference's greedy order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.accelerator import (MappedModel, RunResult, map_model,
                                          run)
from repro_torch.core.energy import FRAME_CYCLES, AcceleratorSpec, EnergyReport
from repro_torch.core.layers import LayerSpec, as_layer_spec
from repro_torch.core.lif import LIFParams
from repro_torch.core.quant import SUPPORTED_BITS, check_bits

# one Pareto point per bit-width config, the reference's schema
PARETO_POINT_KEYS = (
    "config",             # label: "w8" / "w4" / "w2" / "mixed"
    "per_layer_bits",     # stored word width per layer (sign-magnitude)
    "agreement",          # fraction of probe output spikes == 8-bit baseline
    "weight_sram_bytes",  # A-SYN bytes physically allocated, all layers
    "energy_per_frame_j", # modeled total energy / time step on the probe
    "tops_per_w",         # modeled efficiency at this config
    "events_per_s",       # measured engine throughput (None when unmeasured)
)


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of identical entries between two spike rasters."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float((a == b).mean()) if a.size else 1.0


def energy_per_frame(report: EnergyReport, t_steps: int) -> float:
    """Modeled joules per sensor frame (time step) from a probe run."""
    return (report.dynamic_j + report.static_j) / max(int(t_steps), 1)


def pareto_point(config: str, per_layer_bits: "list[int]",
                 result: RunResult, mapped: MappedModel,
                 agreement_frac: float,
                 events_per_s: "float | None" = None) -> dict:
    """Build one Pareto point dict following :data:`PARETO_POINT_KEYS`."""
    t_steps = result.out_spikes.shape[0]
    point = {
        "config": config,
        "per_layer_bits": [int(b) for b in per_layer_bits],
        "agreement": float(agreement_frac),
        "weight_sram_bytes": int(sum(l.sram_bytes for l in mapped.layers)),
        "energy_per_frame_j": energy_per_frame(result.energy, t_steps),
        "tops_per_w": float(result.energy.tops_per_w),
        "events_per_s": None if events_per_s is None else float(events_per_s),
    }
    assert tuple(point) == PARETO_POINT_KEYS
    return point


@dataclasses.dataclass(frozen=True)
class SearchStep:
    """One candidate evaluated by the greedy search."""

    layer: int
    bits: int                 # candidate width tried for this layer
    agreement: float          # whole-config agreement vs 8-bit baseline
    energy_per_frame_j: float
    accepted: bool


@dataclasses.dataclass(frozen=True)
class PrecisionSearchResult:
    per_layer_bits: list[int]
    agreement: float                  # final config vs 8-bit baseline
    baseline_energy: EnergyReport     # all-8-bit probe run
    energy: EnergyReport              # final config probe run
    history: list[SearchStep]

    @property
    def energy_reduction(self) -> float:
        """(baseline - final) / baseline total modeled energy."""
        base = self.baseline_energy.dynamic_j + self.baseline_energy.static_j
        fin = self.energy.dynamic_j + self.energy.static_j
        return (base - fin) / base if base > 0 else 0.0


def search_bits(weights: "list[np.ndarray | LayerSpec]",
                spec: AcceleratorSpec,
                probe_spikes: np.ndarray, *,
                lif: LIFParams = LIFParams(),
                budget: float = 0.02,
                choices: "tuple[int, ...]" = (8, 4, 2),
                frame_cycles: "int | None" = FRAME_CYCLES,
                method: str = "auto",
                compress: bool = False) -> PrecisionSearchResult:
    """Greedy per-layer bit-width search under an accuracy budget.

    ``probe_spikes`` is a ``[T, n_in]`` spike train; agreement is measured
    on the accelerator's output raster against the all-8-bit baseline.
    ``budget`` is the tolerated disagreement fraction (0.02 = accept while
    >= 98% of output spikes match).  ``choices`` lists the candidate widths
    (must be a subset of :data:`repro_torch.core.quant.SUPPORTED_BITS`; 8
    must be included — it is the baseline).  Returns the chosen per-layer
    widths plus the full audit trail of evaluated candidates.
    """
    choices = tuple(sorted({check_bits(int(b)) for b in choices},
                           reverse=True))
    if choices[0] != 8:
        raise ValueError(f"choices must include the 8-bit baseline, got "
                         f"{choices} (supported: {SUPPORTED_BITS})")
    if not 0.0 <= budget < 1.0:
        raise ValueError(f"budget must be in [0, 1), got {budget}")
    probe = np.asarray(probe_spikes, dtype=np.float32)
    if probe.ndim != 2:
        raise ValueError(f"probe_spikes must be [T, n_in], got {probe.shape}")
    specs = [as_layer_spec(w) for w in weights]
    pinned = [ls.bits for ls in specs]   # spec pins win over the search
    n_layers = len(specs)
    t_steps = probe.shape[0]

    def evaluate(bits_list: "list[int]") -> tuple[MappedModel, RunResult]:
        mapped = map_model(specs, spec, lif=lif, quant_bits=list(bits_list),
                           method=method, compress=compress)
        return mapped, run(mapped, probe, frame_cycles=frame_cycles)

    base_bits = [8 if p is None else p for p in pinned]
    _, base_res = evaluate(base_bits)
    base_out = base_res.out_spikes
    floor = 1.0 - budget
    sub8 = [b for b in choices if b < 8]
    history: list[SearchStep] = []
    current = list(base_bits)
    cur_res = base_res
    cur_agree = 1.0

    if sub8:
        # sensitivity probe: each unpinned layer alone at the widest sub-8
        # width; least-sensitive layers get first claim on the budget
        sens: list[tuple[float, int]] = []
        for li in range(n_layers):
            if pinned[li] is not None:
                continue
            trial = list(base_bits)
            trial[li] = sub8[0]
            _, res = evaluate(trial)
            sens.append((1.0 - agreement(res.out_spikes, base_out), li))
        sens.sort()
        for _, li in sens:
            for b in sub8:
                if b >= current[li]:
                    continue
                trial = list(current)
                trial[li] = b
                _, res = evaluate(trial)
                a = agreement(res.out_spikes, base_out)
                ok = a >= floor
                history.append(SearchStep(
                    layer=li, bits=b, agreement=a,
                    energy_per_frame_j=energy_per_frame(res.energy, t_steps),
                    accepted=ok))
                if not ok:
                    break        # narrower widths only disagree more
                current, cur_res, cur_agree = trial, res, a
    return PrecisionSearchResult(
        per_layer_bits=current, agreement=cur_agree,
        baseline_energy=base_res.energy, energy=cur_res.energy,
        history=history)
