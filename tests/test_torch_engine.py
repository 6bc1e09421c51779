"""The port's batched engine (``repro_torch.engine.run_batched``, CPU path)
against the reference's numpy oracle ``repro.core.accelerator.run_batch``:
spikes, DispatchStats, MEM_S&N utilisation, overflow and energy, bit for
bit — including MEM_E caps, B=0, T=1, silent inputs and the golden
equivalence fixtures."""

import json
import pathlib

import numpy as np
import pytest
import torch

from _torch_helpers import (assert_batched_equals_oracle, case_layers,
                            map_both, pruned_mlp, spikes_for)
from repro.core.accelerator import run_batch

from repro_torch.engine import batched_run as br

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "equivalence"


@pytest.mark.parametrize("seed,sizes,density,p_spk", [
    (0, (24, 16, 12, 8), 0.5, 0.3),
    (1, (18, 20, 6), 0.7, 0.5),
    (2, (32, 8), 0.3, 0.15),
])
def test_run_batched_matches_oracle(seed, sizes, density, p_spk):
    rng = np.random.default_rng(seed)
    ref, port = map_both(pruned_mlp(rng, sizes, density), 4, 8)
    spikes = spikes_for(rng, 4, 10, sizes[0], p_spk)
    res = br.run_batched(port, spikes, device="cpu")
    assert_batched_equals_oracle(res, run_batch(ref, spikes), len(sizes) - 1)


def test_run_batched_multi_round():
    rng = np.random.default_rng(3)
    ref, port = map_both(pruned_mlp(rng, (10, 64)), 4, 8)
    assert len(port.layers[0].rounds) == 2
    spikes = spikes_for(rng, 3, 8, 10, 0.4)
    assert_batched_equals_oracle(br.run_batched(port, spikes, device="cpu"),
                                 run_batch(ref, spikes), 1)


@pytest.mark.parametrize("max_events", [1, 3, 5, 100])
def test_run_batched_mem_e_cap(max_events):
    """A finite MEM_E depth drops the highest source indices per step; the
    loss propagates downstream exactly as on the oracle."""
    rng = np.random.default_rng(max_events)
    ref, port = map_both(pruned_mlp(rng, (10, 12, 6), density=0.8), 4, 8)
    spikes = spikes_for(rng, 3, 6, 10, 0.7)
    res = br.run_batched(port, spikes, max_events=max_events, device="cpu")
    assert_batched_equals_oracle(res, run_batch(ref, spikes,
                                                max_events=max_events), 2)
    np.testing.assert_array_equal(
        res.overflow[0], np.maximum((spikes > 0).sum(-1) - max_events, 0))


def test_overflow_propagates_to_downstream_layers(rng):
    """Twin of the reference's test of the same name: on a 3-layer stack
    where the cap binds, the truncated layer-0 stream changes what layers
    1-2 receive, and spikes, stats, utilisation and overflow equal the
    oracle's under the same cap at every depth, 0 included, on both
    routes."""
    ws = pruned_mlp(rng, (14, 12, 10, 6), density=0.8)
    ref, port = map_both(ws, 4, 8, beta=0.85, threshold=0.5,
                         weight_mem_bytes=1 << 16)
    spikes = (rng.random((4, 7, 14)) < 0.6).astype(np.float32)
    for packed_ops in (False, True):
        packed = port.pack(device="cpu", packed_ops=packed_ops)
        full = br.run_batched(packed, spikes)
        for depth in (0, 2, 5, None):
            res = br.run_batched(packed, spikes, max_events=depth)
            assert_batched_equals_oracle(
                res, run_batch(ref, spikes, max_events=depth), 3,
                f"packed_ops={packed_ops} depth={depth}")
            if depth == 2:
                assert res.per_layer_stats[1].events.sum() \
                    < full.per_layer_stats[1].events.sum(), \
                    "cap on layer 0 did not propagate to layer 1"


def test_zero_mem_e_depth(rng):
    """Twin of the reference's test of the same name: a zero-depth MEM_E
    drops every event (silent output, full overflow) on both routes, equal
    to the oracle's."""
    ref, port = map_both(pruned_mlp(rng, (16, 8)), 4, 8,
                         weight_mem_bytes=1 << 16)
    spikes = (rng.random((2, 4, 16)) < 0.5).astype(np.float32)
    for packed_ops in (False, True):
        res = br.run_batched(port.pack(device="cpu", packed_ops=packed_ops),
                             spikes, max_events=0)
        assert res.out_spikes.sum() == 0
        np.testing.assert_array_equal(res.overflow[0], (spikes > 0).sum(-1))
        assert_batched_equals_oracle(res, run_batch(ref, spikes,
                                                    max_events=0), 1)


def test_run_batched_degenerate_shapes():
    """B=0 returns an empty result; T=1 and all-silent batches follow the
    ordinary path and stay bit-exact."""
    rng = np.random.default_rng(4)
    ref, port = map_both(pruned_mlp(rng, (12, 10, 5)), 4, 8)
    packed = port.pack(device="cpu")
    empty = br.run_batched(packed, np.zeros((0, 5, 12), np.float32))
    assert empty.out_spikes.shape == (0, 5, 5)
    assert empty.per_layer_stats[0].cycles.shape == (0, 5)
    assert empty.per_layer_stats[0].mem_e_peak.shape == (0,)
    for spikes in (spikes_for(rng, 3, 1, 12, 0.5),
                   np.zeros((2, 7, 12), np.float32)):
        assert_batched_equals_oracle(br.run_batched(packed, spikes),
                                     run_batch(ref, spikes), 2)
    silent = br.run_batched(packed, np.zeros((2, 7, 12), np.float32))
    assert silent.out_spikes.sum() == 0


def test_with_stats_false_skips_accounting():
    rng = np.random.default_rng(5)
    ref, port = map_both(pruned_mlp(rng, (12, 8)), 4, 8)
    spikes = spikes_for(rng, 2, 4, 12, 0.5)
    res = br.run_batched(port, spikes, with_stats=False, device="cpu")
    assert res.per_layer_stats == [] and res.overflow == []
    for b, oracle in enumerate(run_batch(ref, spikes)):
        np.testing.assert_array_equal(res.out_spikes[b], oracle.out_spikes)


@pytest.mark.parametrize("fixture", ["conv_stride_pad_pool",
                                     "multi_round_dense",
                                     "overflow_cap_propagation"])
def test_golden_fixtures(fixture):
    """The committed golden equivalence cases, rebuilt through the port:
    conv + pool COO rounds, multi-round dense, capped MEM_E."""
    case = json.loads((GOLDEN / f"{fixture}.json").read_text())
    rng = np.random.default_rng(case["seed"])
    layers = case_layers(case, rng)
    ref, port = map_both(layers, case["n_engines"], case["n_caps"],
                         beta=case["beta"], threshold=case["threshold"],
                         quant_bits=case.get("quant_bits", 8),
                         compress=bool(case.get("compress", False)))
    n_in = port.layers[0].n_src
    spikes = spikes_for(rng, case["batch"], case["t"], n_in, case["p_spike"])
    res = br.run_batched(port, spikes, max_events=case["max_events"],
                         device="cpu")
    assert_batched_equals_oracle(
        res, run_batch(ref, spikes, max_events=case["max_events"]),
        len(layers), fixture)


def test_compressed_model_matches_oracle():
    """Compressed models replay every round through the shared dictionary
    into the same fused tile as the uncompressed table walk, and stay
    bit-exact."""
    rng = np.random.default_rng(6)
    ref, port = map_both(pruned_mlp(rng, (14, 30, 6)), 3, 6, compress=True)
    assert port.weight_dict is not None
    packed = port.pack(device="cpu")
    for rl, pl in zip(ref.layers, packed.layers):
        fused = np.zeros((rl.n_src, pl.n_dest_pad), np.float32)
        for rr in rl.rounds:
            assert rr.tables.weight_ptr is not None
            fused[:, rr.neuron_ids] += rr.tables.dense_weights(
                len(rr.neuron_ids))
        np.testing.assert_array_equal(pl.w_fused.numpy(), fused)
    spikes = spikes_for(rng, 3, 6, 14, 0.5)
    assert_batched_equals_oracle(br.run_batched(packed, spikes),
                                 run_batch(ref, spikes), 2)


def test_stats_vectors_match_table_walk():
    """to_torch pads MEM_E2A/MEM_S&N to the requested geometry, and the
    per-source stats vectors kept at pack time match a direct walk."""
    rng = np.random.default_rng(7)
    _, port = map_both(pruned_mlp(rng, (9, 7)), 4, 8)
    tables = port.layers[0].rounds[0].tables
    pt = tables.to_torch("cpu", pad_src=16, pad_rows=tables.n_rows + 5)
    assert pt.e2a_count.shape == (16,) and pt.e2a_count.dtype == torch.int32
    assert pt.sn_valid.shape == (tables.n_rows + 5, 4)
    assert int(pt.e2a_count[9:].sum()) == 0
    assert int(pt.sn_valid[tables.n_rows:].sum()) == 0
    rows_v, cyc_v, ops_v = pt.stats_vectors()
    for m in range(9):
        a, b = int(tables.e2a_addr[m]), int(tables.e2a_count[m])
        assert rows_v[m] == b and cyc_v[m] == max(b, 1)
        assert ops_v[m] == int(tables.sn_valid[a:a + b].sum())


def test_trace_count_counts_new_shapes_only():
    rng = np.random.default_rng(8)
    _, port = map_both(pruned_mlp(rng, (8, 6)), 2, 4)
    packed = port.pack(device="cpu")
    spikes = spikes_for(rng, 2, 3, 8, 0.5)
    n0 = br.trace_count()
    br.run_batched(packed, spikes)
    br.run_batched(packed, spikes)
    assert br.trace_count() == n0 + 1
    br.run_batched(packed, spikes[:, :2])
    br.run_batched(packed, spikes, max_events=2)
    assert br.trace_count() == n0 + 3


def test_cpu_model_captures_no_graph():
    """Only a card's forward is captured as a graph: a CPU model keeps an
    empty graph cache and one input buffer per (B, T) shape, and its
    answers stay the oracle's."""
    rng = np.random.default_rng(11)
    ref, port = map_both(pruned_mlp(rng, (12, 10, 5)), 4, 8)
    packed = port.pack(device="cpu")
    for t in (6, 6, 3):
        spikes = spikes_for(rng, 3, t, 12, 0.5)
        assert_batched_equals_oracle(
            br.run_batched(packed, spikes),
            run_batch(ref, spikes), 2)
    assert packed.graphs == {}
    assert sorted(packed.input_buffers) == [(3, 3), (3, 6)]


def test_replaced_model_starts_without_graphs():
    """The graph cache is no init field: ``dataclasses.replace`` (the
    noise twin's copy) starts a model without its parent's graphs."""
    import dataclasses
    rng = np.random.default_rng(12)
    _, port = map_both(pruned_mlp(rng, (8, 6)), 2, 4)
    packed = port.pack(device="cpu")
    packed.graphs[(1, 8, None)] = object()
    packed.graph_pool = (0, 1)
    twin = dataclasses.replace(packed)
    assert twin.graphs == {} and twin.graph_pool is None


def test_pack_is_memoised_per_device_and_route():
    rng = np.random.default_rng(9)
    _, port = map_both(pruned_mlp(rng, (8, 6)), 2, 4)
    a = port.pack(device="cpu")
    assert port.pack(device="cpu") is a
    assert port.pack(packed_ops=True, device="cpu") is not a
    assert a.device == torch.device("cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """Without a CUDA device the entry points raise unless the caller asks
    for the CPU; nothing falls back on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(10)
    _, port = map_both(pruned_mlp(rng, (8, 6)), 2, 4)
    spikes = spikes_for(rng, 1, 2, 8, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        br.pack_model(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        br.run_batched(port, spikes)
    from repro_torch.engine import run_bucketed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bucketed(port, [spikes[0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        br.run_batched(port.pack(device="cpu"), spikes, device="cuda")
    # a model packed on the CPU runs there without being told again
    assert br.run_batched(port.pack(device="cpu"), spikes).batch == 1
