"""The port's energy model and dispatch accounting against the reference's
committed golden (``tests/golden/energy_menage_paper.json``, read only):
the ``menage_paper`` N-MNIST MLP on Accel_1, built as
tests/test_golden_energy.py builds it, every number within the golden's
own ``RTOL 1e-9`` and every count exact; then the same snapshot taken from
the port's batched engine."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro_torch.configs.menage_paper import NMNIST_SNN
from repro_torch.core.accelerator import map_model, run
from repro_torch.core.energy import ACCEL_1
from repro_torch.engine import run_batched

GOLDEN = pathlib.Path(__file__).parent / "golden" / "energy_menage_paper.json"
RTOL = 1e-9


def _weights():
    sizes = NMNIST_SNN.layer_sizes            # (2312, 200, 100, 40, 10)
    rng = np.random.default_rng(0)
    ws = []
    for i in range(len(sizes) - 1):
        w = rng.normal(0, 0.5, (sizes[i], sizes[i + 1]))
        th = np.quantile(np.abs(w), 0.5)      # 50% L1 prune
        w[np.abs(w) < th] = 0
        ws.append(w.astype(np.float32))
    return ws


@pytest.fixture(scope="module")
def golden_case():
    model = map_model(_weights(), ACCEL_1, lif=NMNIST_SNN.lif,
                      method="greedy")
    spikes = (np.random.default_rng(1)
              .random((NMNIST_SNN.num_steps, NMNIST_SNN.layer_sizes[0]))
              < 0.02).astype(np.float32)
    return model, spikes


def _snapshot(model, energy, stats_list, util_list, out_spikes) -> dict:
    layers = []
    for layer, stats, util in zip(model.layers, stats_list, util_list):
        layers.append({
            "rounds": len(layer.rounds),
            "weight_bytes": layer.weight_bytes,
            "sram_bytes": layer.sram_bytes,
            "sn_rows": sum(r.tables.n_rows for r in layer.rounds),
            "cycles": int(stats.cycles.sum()),
            "rows_touched": int(stats.rows_touched.sum()),
            "engine_ops": int(stats.engine_ops.sum()),
            "events": int(stats.events.sum()),
            "sn_bytes_touched": int(stats.sn_bytes_touched.sum()),
            "mem_e_peak": int(stats.mem_e_peak),
            "utilization": [float(u) for u in util],
        })
    return {"energy": dataclasses.asdict(energy), "layers": layers,
            "out_spike_count": int(out_spikes.sum())}


def _assert_close(path: str, got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{path}: keys {sorted(got)} != golden {sorted(want)}"
        for k in want:
            _assert_close(f"{path}.{k}", got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want), f"{path}: length changed"
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(f"{path}[{i}]", g, w)
    elif isinstance(want, float):
        assert np.isclose(got, want, rtol=RTOL, atol=0.0), \
            f"{path}: {got!r} != golden {want!r}"
    else:
        assert got == want, f"{path}: {got!r} != golden {want!r}"


def test_port_oracle_reproduces_energy_golden(golden_case):
    model, spikes = golden_case
    res = run(model, spikes)
    snap = _snapshot(model, res.energy, res.per_layer_stats,
                     res.per_layer_util, res.out_spikes)
    assert snap["out_spike_count"] > 0 and snap["energy"]["total_ops"] > 0
    _assert_close("golden", snap, json.loads(GOLDEN.read_text()))


def test_port_engine_reproduces_energy_golden(golden_case):
    model, spikes = golden_case
    res = run_batched(model.pack(device="cpu"), spikes[None])
    snap = _snapshot(model, res.sample_energy(0), res.sample_stats(0),
                     [u[0] for u in res.per_layer_util], res.out_spikes[0])
    _assert_close("golden", snap, json.loads(GOLDEN.read_text()))


def test_port_energy_equals_reference_run(golden_case):
    """Beyond the golden's tolerance: the port's oracle and the reference's
    on the same layers give equal energy reports, float for float."""
    from repro.core.accelerator import map_model as ref_map_model
    from repro.core.accelerator import run as ref_run
    from repro.core.energy import ACCEL_1 as REF_ACCEL_1
    from repro.core.lif import LIFParams as RefLIF
    model, spikes = golden_case
    lif = NMNIST_SNN.lif
    ref = ref_map_model(_weights(), REF_ACCEL_1,
                        lif=RefLIF(beta=lif.beta, threshold=lif.threshold),
                        method="greedy")
    assert dataclasses.asdict(run(model, spikes).energy) == \
        dataclasses.asdict(ref_run(ref, spikes).energy)
