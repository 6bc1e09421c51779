"""The port's per-layer bit-width search and its Pareto points against the
reference package: the same numpy-seeded layers and probe give the same
chosen widths, agreement, search history and energy reports, exactly; and
the mixed-width model the search picks runs through the port's packed
engine bit-exact against the numpy oracle."""

import dataclasses

import numpy as np
import pytest

from repro.core import precision as ref_prec
from repro.core.accelerator import map_model as ref_map_model
from repro.core.accelerator import run as ref_run
from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.energy import energy_model as ref_energy_model
from repro.core.layers import Dense as RefDense

from repro_torch.core import precision as prec
from repro_torch.core.accelerator import map_model, run
from repro_torch.core.energy import AcceleratorSpec, energy_model
from repro_torch.core.layers import Dense
from repro_torch.core.lif import LIFParams
from repro_torch.engine import run_batched

SPEC_ARGS = dict(n_cores=4, n_engines=8, n_caps=16, weight_mem_bytes=1 << 20)
SPEC = AcceleratorSpec("prec-test", **SPEC_ARGS)
REF_SPEC = RefSpec("prec-test", **SPEC_ARGS)


def _stack(rng, sizes=(24, 32, 10), scale=0.6):
    return [rng.normal(0, scale, (sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(len(sizes) - 1)]


def _probe(rng, n_in, t=10, p=0.3):
    return (rng.random((t, n_in)) < p).astype(np.float32)


def _energy(rep) -> dict:
    return dataclasses.asdict(rep)


def _search_both(layers, probe, **kw):
    """``search_bits`` of both packages on the same layers (bare matrices,
    or ``(w, bits)`` pairs for pinned ``Dense`` specs); every field of the
    two results held equal, and the port's returned."""
    def specs(dense):
        return [dense(w=w[0], bits=w[1]) if isinstance(w, tuple) else w
                for w in layers]
    ref = ref_prec.search_bits(specs(RefDense), REF_SPEC, probe, **kw)
    port = prec.search_bits(specs(Dense), SPEC, probe, **kw)
    assert port.per_layer_bits == ref.per_layer_bits
    assert port.agreement == ref.agreement
    assert [dataclasses.astuple(s) for s in port.history] == \
        [dataclasses.astuple(s) for s in ref.history]
    assert _energy(port.baseline_energy) == _energy(ref.baseline_energy)
    assert _energy(port.energy) == _energy(ref.energy)
    assert port.energy_reduction == ref.energy_reduction
    return port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [0.0, 0.05, 0.1, 0.3, 0.5])
def test_search_matches_reference(seed, budget):
    rng = np.random.default_rng(seed)
    ws = _stack(rng, sizes=(24, 32, 16, 10))
    res = _search_both(ws, _probe(rng, 24), budget=budget)
    assert res.agreement >= 1.0 - budget
    assert all(s.agreement >= 1.0 - budget for s in res.history if s.accepted)
    assert 0.0 <= res.energy_reduction <= 1.0


def test_search_zero_budget_keeps_8bit(rng):
    res = _search_both(_stack(rng), _probe(rng, 24), budget=0.0)
    assert res.per_layer_bits == [8, 8] and res.agreement == 1.0


def test_search_loose_budget_downgrades(rng):
    res = _search_both(_stack(rng), _probe(rng, 24), budget=0.5)
    assert any(b < 8 for b in res.per_layer_bits)
    assert res.agreement >= 0.5


@pytest.mark.parametrize("choices", [(8, 4), (8, 2), (2, 8, 4), (8,)])
def test_search_choices_match_reference(rng, choices):
    res = _search_both(_stack(rng), _probe(rng, 24), budget=0.5,
                       choices=choices)
    assert all(b in choices for b in res.per_layer_bits)
    if choices == (8,):
        assert res.per_layer_bits == [8, 8] and res.history == []
        assert isinstance(res, prec.PrecisionSearchResult)


def test_search_respects_pinned_spec_bits(rng):
    ws = _stack(rng)
    res = _search_both([(ws[0], 4), ws[1]], _probe(rng, 24), budget=0.0)
    assert res.per_layer_bits[0] == 4
    assert all(s.layer != 0 for s in res.history)


def test_search_compress_and_method_match_reference(rng):
    ws = _stack(rng)
    _search_both(ws, _probe(rng, 24), budget=0.3, compress=True,
                 method="greedy", frame_cycles=None)


@pytest.mark.parametrize("kw,match", [
    (dict(choices=(4, 2)), "8-bit baseline"),
    (dict(choices=(8, 3)), "unsupported"),
    (dict(budget=1.5), "budget"),
    (dict(budget=-0.1), "budget"),
])
def test_search_validation_matches_reference(rng, kw, match):
    ws, probe = _stack(rng), _probe(rng, 24)
    with pytest.raises(ValueError, match=match) as port_err:
        prec.search_bits(ws, SPEC, probe, **kw)
    with pytest.raises(ValueError) as ref_err:
        ref_prec.search_bits(ws, REF_SPEC, probe, **kw)
    assert str(port_err.value) == str(ref_err.value)


def test_search_rejects_a_batched_probe(rng):
    ws, probe = _stack(rng), _probe(rng, 24)
    with pytest.raises(ValueError, match="probe_spikes"):
        prec.search_bits(ws, SPEC, probe[None])


def test_search_result_config_runs(rng):
    ws, probe = _stack(rng), _probe(rng, 24)
    res = _search_both(ws, probe, budget=0.3)
    m = map_model(ws, SPEC, quant_bits=res.per_layer_bits)
    rr = run(m, probe)
    assert [l.bits for l in m.layers] == res.per_layer_bits
    assert rr.energy.breakdown["E_mac_J"] == res.energy.breakdown["E_mac_J"]


@pytest.mark.parametrize("bits", [[8, 8], [4, 8], [2, 4], [2, 2]])
def test_pareto_point_matches_reference(rng, bits):
    ws, probe = _stack(rng), _probe(rng, 24)
    m = map_model(ws, SPEC, quant_bits=bits)
    rm = ref_map_model(ws, REF_SPEC, quant_bits=bits)
    base = ref_run(ref_map_model(ws, REF_SPEC), probe).out_spikes
    rr, ref_rr = run(m, probe), ref_run(rm, probe)
    a = prec.agreement(rr.out_spikes, base)
    assert a == ref_prec.agreement(ref_rr.out_spikes, base)
    pt = prec.pareto_point("mixed", bits, rr, m, a, events_per_s=1e5)
    assert tuple(pt) == prec.PARETO_POINT_KEYS == ref_prec.PARETO_POINT_KEYS
    assert pt == ref_prec.pareto_point("mixed", bits, ref_rr, rm, a,
                                       events_per_s=1e5)
    assert pt["weight_sram_bytes"] == sum(l.sram_bytes for l in m.layers)
    assert pt["energy_per_frame_j"] == \
        prec.energy_per_frame(rr.energy, probe.shape[0])
    assert prec.pareto_point("w8", bits, rr, m, a)["events_per_s"] is None


def test_agreement_basics():
    a = np.array([[1.0, 0.0], [0.0, 1.0]])
    assert prec.agreement(a, a) == 1.0
    assert prec.agreement(a, 1 - a) == 0.0
    assert prec.agreement(a[:0], a[:0]) == 1.0
    with pytest.raises(ValueError):
        prec.agreement(a, a[:1])


def test_energy_scales_with_bits(rng):
    ws, probe = _stack(rng), _probe(rng, 24)
    stats = run(map_model(ws, SPEC, quant_bits=8), probe).per_layer_stats
    ref_stats = ref_run(ref_map_model(ws, REF_SPEC, quant_bits=8),
                        probe).per_layer_stats
    e = {b: energy_model(SPEC, stats, per_core_bits=[b, b])
         for b in (8, 4, 2)}
    for b, rep in e.items():
        assert _energy(rep) == _energy(ref_energy_model(
            REF_SPEC, ref_stats, per_core_bits=[b, b]))
    assert e[8].breakdown["E_mac_J"] > e[4].breakdown["E_mac_J"] \
        > e[2].breakdown["E_mac_J"] > 0
    assert e[8].breakdown["E_mac_J"] == \
        energy_model(SPEC, stats).breakdown["E_mac_J"]
    with pytest.raises(ValueError, match="per_core_bits"):
        energy_model(SPEC, stats, per_core_bits=[8])


@pytest.mark.parametrize("bits", [[4, 8], [8, 2], [2, 4], [4, 4]])
def test_per_layer_bits_reach_engine_energy(rng, bits):
    """A mixed-width model on the port's packed route (the CPU path of the
    served one): ``per_layer_bits``, spikes, dispatch stats and energy
    equal the oracle's, and the energy the reference's."""
    ws, probe = _stack(rng), _probe(rng, 24)
    m = map_model(ws, SPEC, quant_bits=bits)
    packed = m.pack(packed_ops=True, device="cpu")
    assert [l.bits for l in packed.layers] == bits
    res = run_batched(packed, probe[None])
    assert res.per_layer_bits == bits
    oracle = run(m, probe)
    np.testing.assert_array_equal(res.out_spikes[0], oracle.out_spikes)
    assert res.sample_energy(0) == oracle.energy
    assert _energy(oracle.energy) == _energy(
        ref_run(ref_map_model(ws, REF_SPEC, quant_bits=bits), probe).energy)


def test_searched_widths_serve_bit_exact(rng):
    """The search's widths, mapped and served through ``run_bucketed`` on
    the packed route (as chip_smoke.py's precision phase serves them on
    the card): every request equal to the oracle."""
    from repro_torch.engine import BucketPolicy, run_bucketed
    ws = _stack(rng, sizes=(24, 32, 16, 10), scale=0.8)
    lif = LIFParams(beta=0.85, threshold=0.6)
    res = prec.search_bits(ws, SPEC, _probe(rng, 24), lif=lif, budget=0.3)
    m = map_model(ws, SPEC, lif=lif, quant_bits=res.per_layer_bits)
    streams = [_probe(rng, 24, t=t) for t in (3, 9, 5, 12)]
    out = run_bucketed(m.pack(packed_ops=True, device="cpu"), streams,
                       policy=BucketPolicy(batch_sizes=(2, 4),
                                           time_steps=(8, 16)))
    for r, s in zip(out, streams):
        oracle = run(m, s)
        np.testing.assert_array_equal(r.out_spikes, oracle.out_spikes)
        assert r.energy() == oracle.energy
