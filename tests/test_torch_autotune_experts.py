"""The port's engine-grid autotuner and MoE expert placement against the
reference package: the same candidate grids, scores and chosen grid, the
same placements; and the port's engine equal to the port's oracle on the
autotuned (compressed) model."""

import dataclasses

import numpy as np
import pytest

from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.layers import Conv2d as RefConv2d
from repro.core.layers import Dense as RefDense
from repro.core.mapping import autotune as ref_autotune
from repro.core.mapping import experts as ref_experts

from repro_torch.core.accelerator import run_batch
from repro_torch.core.energy import ACCEL_1, ACCEL_2, AcceleratorSpec
from repro_torch.core.layers import Conv2d, Dense
from repro_torch.core.mapping import (AutotuneResult, autotune_grid,
                                      candidate_grids, estimate_cycles)
from repro_torch.core.mapping.experts import (place_experts,
                                              placement_peak_load)
from repro_torch.engine import run_batched

from _torch_helpers import STAT_FIELDS

SPEC_ARGS = dict(n_cores=3, n_engines=4, n_caps=8, weight_mem_bytes=1 << 20)
SPEC = AcceleratorSpec("comp", **SPEC_ARGS)
REF_SPEC = RefSpec("comp", **SPEC_ARGS)


def _stack(rng, conv, dense):
    """tests/test_compression.py::_stack, built with either package's
    layer classes from the same draws."""
    k = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    k[rng.random(k.shape) > 0.7] = 0
    c = conv(kernel=k, in_shape=(2, 6, 6), padding=1)
    w1 = rng.normal(size=(c.n_dest, 20)).astype(np.float32)
    w1[rng.random(w1.shape) > 0.4] = 0
    w2 = rng.normal(size=(20, 5)).astype(np.float32)
    return [c, dense(w=w1), dense(w=w2)]


def _tune_both(seed, **kw):
    ref = ref_autotune.autotune_grid(
        _stack(np.random.default_rng(seed), RefConv2d, RefDense), REF_SPEC,
        **kw)
    port = autotune_grid(_stack(np.random.default_rng(seed), Conv2d, Dense),
                         SPEC, **kw)
    assert [s.as_dict() for s in port.scores] == \
        [s.as_dict() for s in ref.scores]
    assert port.best.as_dict() == ref.best.as_dict()
    assert port.default.as_dict() == ref.default.as_dict()
    assert port.tuned == ref.tuned
    assert (port.spec.n_engines, port.spec.n_caps, port.spec.name) == \
        (ref.spec.n_engines, ref.spec.n_caps, ref.spec.name)
    return port


def _engine_equals_oracle(model, spikes):
    res = run_batched(model.pack(device="cpu"), spikes)
    for b, oracle in enumerate(run_batch(model, spikes)):
        np.testing.assert_array_equal(res.out_spikes[b], oracle.out_spikes)
        for got, want in zip(res.sample_stats(b), oracle.per_layer_stats):
            for f in STAT_FIELDS:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)
            assert got.mem_e_peak == want.mem_e_peak
        for li in range(len(model.layers)):
            np.testing.assert_array_equal(res.per_layer_util[li][b],
                                          oracle.per_layer_util[li])


@pytest.mark.parametrize("compress", [True, False])
def test_autotuned_compressed_model_equivalent(compress):
    res = _tune_both(41, compress=compress)
    assert isinstance(res, AutotuneResult)
    assert res.best.rounds_per_timestep <= res.default.rounds_per_timestep
    n_src = res.model.layers[0].n_src
    spikes = (np.random.default_rng(6).random((2, 4, n_src)) < 0.2
              ).astype(np.float32)
    _engine_equals_oracle(res.model, spikes)


@pytest.mark.parametrize("kw", [
    dict(activity=0.5),
    dict(max_candidates=3),
    dict(candidates=[(2, 16), (8, 4)]),          # default appended
    dict(quant_bits=4, method="greedy"),
])
def test_autotune_options_match_reference(kw):
    res = _tune_both(7, **kw)
    assert (SPEC.n_engines, SPEC.n_caps) in \
        [(s.n_engines, s.n_caps) for s in res.scores]


@pytest.mark.parametrize("spec", [ACCEL_1, ACCEL_2, SPEC],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("max_candidates", [1, 4, 8, 32])
def test_candidate_grids_match_reference(spec, max_candidates):
    ref_spec = RefSpec(**dataclasses.asdict(spec))
    got = candidate_grids(spec, max_candidates=max_candidates)
    assert got == ref_autotune.candidate_grids(
        ref_spec, max_candidates=max_candidates)
    assert (spec.n_engines, spec.n_caps) in got


@pytest.mark.parametrize("activity", [0.0, 0.1, 0.37, 1.0])
def test_estimate_cycles_matches_reference(activity):
    res = _tune_both(3)
    ref = ref_autotune.autotune_grid(
        _stack(np.random.default_rng(3), RefConv2d, RefDense), REF_SPEC)
    assert estimate_cycles(res.model, activity) == \
        ref_autotune.estimate_cycles(ref.model, activity)


def test_autotune_every_grid_infeasible_raises():
    from repro_torch.core.mapping import MappingError
    tiny = AcceleratorSpec("tiny", n_cores=3, n_engines=2, n_caps=2,
                           weight_mem_bytes=16)
    with pytest.raises(MappingError, match="no feasible grid"):
        autotune_grid(_stack(np.random.default_rng(0), Conv2d, Dense), tiny)


def test_balanced_placement_qwen3_shape(rng):
    """128 experts on 16 devices, 8 slots each (the qwen3 EP layout)."""
    load = rng.pareto(2.0, 128) + 0.1
    assign = place_experts(load, n_devices=16, slots_per_device=8)
    np.testing.assert_array_equal(
        assign, ref_experts.place_experts(load, 16, 8))
    assert np.bincount(assign, minlength=16).max() <= 8
    assert (assign >= 0).all()
    peak = placement_peak_load(load, assign, 16)
    assert peak == ref_experts.placement_peak_load(load, assign, 16)
    assert peak <= 1.35 * load.sum() / 16 + load.max()


@pytest.mark.parametrize("seed", range(12))
def test_placement_matches_reference(seed):
    rng = np.random.default_rng(seed)
    e = int(rng.integers(4, 33))
    d = int(rng.integers(2, 9))
    slots = int(np.ceil(e / d)) + int(rng.integers(0, 3))
    load = rng.random(e) + 0.01
    assign = place_experts(load, d, slots)
    np.testing.assert_array_equal(assign,
                                  ref_experts.place_experts(load, d, slots))
    assert np.bincount(assign, minlength=d).max() <= slots
    assert (assign >= 0).all()


def test_beats_naive_contiguous():
    load = np.ones(32)
    load[:4] = 20.0
    naive = np.repeat(np.arange(4), 8)
    assign = place_experts(load, n_devices=4, slots_per_device=8)
    assert placement_peak_load(load, assign, 4) < \
        placement_peak_load(load, naive, 4)


def test_placement_needs_enough_slots():
    with pytest.raises(AssertionError, match="not enough slots"):
        place_experts(np.ones(9), n_devices=2, slots_per_device=4)
