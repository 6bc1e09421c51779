"""The port's host side (mapping, control memories, oracle, energy,
carry-across) against the reference package: every table array equal."""

import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_helpers import (assert_stats_equal, case_layers, map_both,
                            pruned_mlp, spikes_for)
from repro.core.accelerator import run as ref_run
from repro.core.mapping import MappingProblem as RefProblem
from repro.core.mapping import solve_mapping as ref_solve
from repro.core.memories import dispatch_simulate as ref_dispatch
from repro.core.memories import mem_sn_utilization as ref_util

from repro_torch.convert import (mapped_from_reference, mapped_to_arrays,
                                 specs_from_reference)
from repro_torch.core.accelerator import reference_forward
from repro_torch.core.accelerator import run as port_run
from repro_torch.core.mapping import MappingProblem, solve_mapping
from repro_torch.core.memories import dispatch_simulate, mem_sn_utilization
from repro_torch.engine.batched_run import pack_model

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "equivalence"


def assert_arrays_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype.kind == np.asarray(b[k]).dtype.kind, k


MAP_CASES = {
    "mlp": dict(sizes=(24, 16, 12, 8), engines=4, caps=8, kw={}),
    "multi_round": dict(sizes=(10, 64), engines=4, caps=8, kw={}),
    "compressed": dict(sizes=(20, 40, 6), engines=3, caps=6,
                       kw=dict(compress=True)),
    "w4": dict(sizes=(16, 24, 8), engines=4, caps=4, kw=dict(quant_bits=4)),
    "mixed": dict(sizes=(16, 24, 12, 8), engines=4, caps=8,
                  kw=dict(quant_bits=[8, 4, 2])),
}


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_map_model_matches_reference(name):
    """Quantized weights, mappings, every MEM_E2A / MEM_S&N / A-SYN array,
    compression pointers and SRAM accounting equal the reference's."""
    c = MAP_CASES[name]
    ws = pruned_mlp(np.random.default_rng(len(name)), c["sizes"])
    ref, port = map_both(ws, c["engines"], c["caps"], **c["kw"])
    assert_arrays_equal(mapped_to_arrays(port), mapped_to_arrays(ref))


@pytest.mark.parametrize("fixture", ["conv_stride_pad_pool",
                                     "overflow_cap_propagation"])
def test_map_model_conv_matches_reference(fixture):
    case = json.loads((GOLDEN / f"{fixture}.json").read_text())
    layers = case_layers(case, np.random.default_rng(case["seed"]))
    ref, port = map_both(layers, case["n_engines"], case["n_caps"],
                         beta=case["beta"], threshold=case["threshold"])
    assert_arrays_equal(mapped_to_arrays(port), mapped_to_arrays(ref))


@pytest.mark.parametrize("method,fanout", [
    ("auto", None), ("maxflow", None), ("greedy", 3), ("reduced_ilp", 3),
    ("full_ilp", 2),
])
def test_solvers_match_reference(method, fanout):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(6, 9)) * (rng.random((6, 9)) < 0.5)
    a = solve_mapping(MappingProblem.from_weights(w, 3, 2, fanout=fanout),
                      method=method)
    b = ref_solve(RefProblem.from_weights(w, 3, 2, fanout=fanout),
                  method=method)
    np.testing.assert_array_equal(a.engine, b.engine)
    np.testing.assert_array_equal(a.capacitor, b.capacitor)
    assert (a.n_assigned, a.objective, a.solver) == \
        (b.n_assigned, b.objective, b.solver)


@pytest.mark.parametrize("max_events", [None, 3])
def test_dispatch_simulate_matches_reference(max_events):
    rng = np.random.default_rng(7)
    ref, port = map_both(pruned_mlp(rng, (12, 20)), 3, 4)
    spikes = spikes_for(rng, 1, 6, 12, 0.5)[0]
    for rr, pr in zip(ref.layers[0].rounds, port.layers[0].rounds):
        n = len(pr.neuron_ids)
        cur_p, st_p = dispatch_simulate(pr.tables, spikes, n, max_events)
        cur_r, st_r = ref_dispatch(rr.tables, spikes, n, max_events)
        np.testing.assert_array_equal(cur_p, cur_r)
        assert_stats_equal(st_p, st_r)
        np.testing.assert_array_equal(
            mem_sn_utilization(pr.tables, spikes, 50, max_events),
            ref_util(rr.tables, spikes, 50, max_events))


def test_oracle_run_and_energy_match_reference():
    rng = np.random.default_rng(8)
    ref, port = map_both(pruned_mlp(rng, (18, 20, 6), density=0.7), 4, 8)
    spikes = spikes_for(rng, 1, 9, 18, 0.5)[0]
    a, b = port_run(port, spikes, max_events=6), ref_run(ref, spikes,
                                                         max_events=6)
    np.testing.assert_array_equal(a.out_spikes, b.out_spikes)
    for sa, sb in zip(a.per_layer_stats, b.per_layer_stats):
        assert_stats_equal(sa, sb)
    for ua, ub in zip(a.per_layer_util, b.per_layer_util):
        np.testing.assert_array_equal(ua, ub)
    for oa, ob in zip(a.overflow, b.overflow):
        np.testing.assert_array_equal(oa, ob)
    assert dict(vars(a.energy)) == dict(vars(b.energy))


def test_dense_replay_equals_per_row_replay():
    """pack_model's vectorised replay builds the same fused tile as the
    reference's per-row Python replay (MemTables.dense_weights), round by
    round, with multi-round layers included."""
    rng = np.random.default_rng(9)
    ref, port = map_both(pruned_mlp(rng, (14, 70, 9)), 4, 8)
    assert max(len(l.rounds) for l in ref.layers) > 1
    packed = pack_model(port, device="cpu")
    for rl, pl in zip(ref.layers, packed.layers):
        fused = np.zeros((rl.n_src, pl.n_dest_pad), np.float32)
        for rr in rl.rounds:
            fused[:, rr.neuron_ids] += rr.tables.dense_weights(
                len(rr.neuron_ids))
        np.testing.assert_array_equal(pl.w_fused.numpy(), fused)


@pytest.mark.parametrize("compress", [False, True])
def test_mapped_from_reference_round_trips(compress):
    """A reference mapped model carried across as flat numpy arrays gives a
    port model whose arrays — and whose oracle run — are the reference's."""
    rng = np.random.default_rng(10)
    ref, _ = map_both(pruned_mlp(rng, (16, 30, 7)), 3, 6, compress=compress)
    arrays = mapped_to_arrays(ref)
    port = mapped_from_reference(arrays)
    assert_arrays_equal(mapped_to_arrays(port), arrays)
    spikes = spikes_for(rng, 1, 5, 16, 0.4)[0]
    np.testing.assert_array_equal(port_run(port, spikes).out_spikes,
                                  ref_run(ref, spikes).out_spikes)


def test_specs_from_reference_mlp_params():
    """The reference MLP's parameter list maps through the port exactly as
    through the reference; reference_forward agrees."""
    import jax
    from repro.snn.mlp import SNNConfig, init_snn
    params = [np.asarray(p) for p in
              init_snn(jax.random.key(0), SNNConfig(layer_sizes=(20, 12, 5)))]
    specs = specs_from_reference(params)
    assert [s.w.shape for s in specs] == [(20, 12), (12, 5)]
    ref, port = map_both([s.w for s in specs], 3, 6)
    assert_arrays_equal(mapped_to_arrays(port), mapped_to_arrays(ref))
    spikes = spikes_for(np.random.default_rng(1), 1, 6, 20, 0.5)[0]
    from repro.core.accelerator import reference_forward as ref_forward
    from repro.core.lif import LIFParams as RefLIF
    from repro_torch.core.lif import LIFParams
    np.testing.assert_array_equal(
        reference_forward(specs, LIFParams(), spikes),
        ref_forward(params, RefLIF(), spikes))
