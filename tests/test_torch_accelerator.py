"""The port's end-to-end software twin (Algorithm 1 and Fig. 1's chain):
twin of ``tests/test_accelerator.py``.

Each test maps the same seeded pruned MLP in both packages, asserts the
reference test's own assertions on the port, and holds the port's rounds,
spikes and energy report equal to the reference's, exactly.
``test_accelerator_matches_reference`` is twinned by
``tests/test_torch_mapping.py::test_oracle_run_and_energy_match_reference``.
"""

import dataclasses

import numpy as np
import pytest

from _torch_helpers import map_both, pruned_mlp
from repro.core.accelerator import map_model as ref_map_model
from repro.core.accelerator import run as ref_run
from repro.core.energy import ACCEL_1 as REF_ACCEL_1
from repro.core.energy import ACCEL_2 as REF_ACCEL_2
from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.mapping import MappingError as RefMappingError

from repro_torch.core.accelerator import map_model, reference_forward, run
from repro_torch.core.energy import ACCEL_1, ACCEL_2, AcceleratorSpec
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import MappingError


def _energy(e) -> dict:
    return dataclasses.asdict(e) if dataclasses.is_dataclass(e) else vars(e)


def test_all_neurons_assigned_when_capacity_suffices(rng):
    ref, port = map_both(pruned_mlp(rng, (24, 16, 12, 8)), 4, 8)
    for layer, rl in zip(port.layers, ref.layers):
        assert len(layer.rounds) == 1
        assert layer.mapping.n_assigned == layer.n_dest
        np.testing.assert_array_equal(layer.mapping.engine,
                                      rl.mapping.engine)


def test_wide_layer_runs_in_rounds(rng):
    """A layer wider than M*N capacitors runs in capacitor-reassignment
    rounds (paper §III-D) and still computes exactly: the oracle equals
    the dense reference and the reference's oracle."""
    ws = pruned_mlp(rng, (10, 64))  # 64 > 4*8 = 32
    lif = LIFParams(beta=0.8, threshold=0.7)
    ref, model = map_both(ws, 4, 8)
    assert len(model.layers[0].rounds) == 2 == len(ref.layers[0].rounds)
    assert model.layers[0].n_assigned == 64
    spikes = (rng.random((8, 10)) < 0.4).astype(np.float32)
    res = run(model, spikes)
    want = reference_forward([l.w_q for l in model.layers], lif, spikes)
    assert np.array_equal(res.out_spikes, want)
    np.testing.assert_array_equal(res.out_spikes,
                                  ref_run(ref, spikes).out_spikes)


def test_weight_memory_violation_raises(rng):
    ws = pruned_mlp(rng, (16, 16), density=1.0)
    with pytest.raises(MappingError, match="SRAM"):
        map_model(ws, AcceleratorSpec("tiny", 1, 4, 8, weight_mem_bytes=4))
    with pytest.raises(RefMappingError, match="SRAM"):
        ref_map_model(ws, RefSpec("tiny", 1, 4, 8, weight_mem_bytes=4))


def test_energy_report_fields(rng):
    """Every field of the energy report is set and equals the
    reference's."""
    ref, model = map_both(pruned_mlp(rng, (24, 16, 12, 8)), 4, 8,
                          weight_mem_bytes=1 << 16)
    spikes = (rng.random((12, 24)) < 0.3).astype(np.float32)
    e = run(model, spikes).energy
    assert e.total_ops > 0
    assert e.tops_per_w > 0
    assert e.dynamic_j > 0 and e.static_j > 0
    assert 0 < e.utilization <= 1
    assert _energy(e) == _energy(ref_run(ref, spikes).energy)


def test_more_engines_improve_efficiency(rng):
    """More A-NEURON engines pack more synaptic ops per dispatch cycle
    (Accel2 against Accel1's mechanism): same model, same capacitor count,
    M=2 against M=8, in throughput mode; each report the reference's."""
    ws = pruned_mlp(rng, (24, 16, 12, 8), density=0.9)
    spikes = (rng.random((12, 24)) < 0.5).astype(np.float32)
    reports = {}
    for name, m, n in (("narrow", 2, 16), ("wide", 8, 4)):
        e = run(map_model(ws, AcceleratorSpec(name, 3, m, n, 1 << 16)),
                spikes, frame_cycles=None).energy
        want = ref_run(ref_map_model(ws, RefSpec(name, 3, m, n, 1 << 16)),
                       spikes, frame_cycles=None).energy
        assert _energy(e) == _energy(want)
        reports[name] = e
    assert reports["wide"].tops_per_w > reports["narrow"].tops_per_w
    assert reports["wide"].wall_time_s < reports["narrow"].wall_time_s


def test_paper_specs_shapes():
    assert ACCEL_1.n_cores == 4 and ACCEL_1.n_engines == 10 \
        and ACCEL_1.n_caps == 16
    assert ACCEL_2.n_cores == 5 and ACCEL_2.n_engines == 20 \
        and ACCEL_2.n_caps == 32
    for port, ref in ((ACCEL_1, REF_ACCEL_1), (ACCEL_2, REF_ACCEL_2)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
