"""The port's memory-based event control (paper §III-C, Fig. 4): twin of
``tests/test_memories.py``.

Each test maps the same seeded layer in both packages, asserts the
reference test's own assertions on the port, and holds the port's tables,
dispatch statistics and utilisation equal to the reference's, exactly.
The dispatch against the dense ``spikes @ W`` keeps the reference's
``atol=1e-5`` (the dense product sums in another order).
"""

import numpy as np
from _hypothesis_compat import given, settings, st

from repro.core.mapping import MappingProblem as RefProblem
from repro.core.mapping import solve_mapping as ref_solve
from repro.core.memories import build_event_memories as ref_build
from repro.core.memories import dispatch_simulate as ref_dispatch
from repro.core.memories import mem_sn_utilization as ref_util

from repro_torch.core.mapping import MappingProblem, solve_mapping
from repro_torch.core.memories import (build_event_memories,
                                       dispatch_simulate, mem_sn_utilization)


def _mapped_layer(rng, n_src=12, n_dest=10, m=3, n=4, density=0.5):
    """``(w, port solution, port tables, reference tables)``."""
    w = rng.normal(size=(n_src, n_dest)).astype(np.float32)
    w[rng.random((n_src, n_dest)) > density] = 0
    sol = solve_mapping(MappingProblem.from_weights(w, n_engines=m,
                                                    n_caps=n))
    ref = ref_build(w, ref_solve(RefProblem.from_weights(w, n_engines=m,
                                                         n_caps=n)), m, n)
    tables = build_event_memories(w, sol, m, n)
    for f in ("e2a_addr", "e2a_count", "sn_valid", "sn_virt", "sn_waddr",
              "weight_mem"):
        np.testing.assert_array_equal(getattr(tables, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    return w, sol, tables, ref


def _assert_stats_equal(got, want):
    for f in ("cycles", "rows_touched", "engine_ops", "events",
              "sn_bytes_touched"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_e2a_row_counts_match_engine_grouping(rng):
    w, sol, tables, _ = _mapped_layer(rng)
    for src in range(w.shape[0]):
        dests = np.nonzero(w[src])[0]
        dests = dests[sol.engine[dests] >= 0]
        per_engine = np.bincount(sol.engine[dests], minlength=3) \
            if len(dests) else np.zeros(3, int)
        assert tables.e2a_count[src] == (per_engine.max() if len(dests)
                                         else 0)


def test_rows_one_destination_per_engine_per_cycle(rng):
    """Each MEM_S&N row drives each A-NEURON at most once: the valid bits
    are a boolean [R, M] table, one entry per engine per row."""
    _, _, tables, _ = _mapped_layer(rng)
    assert tables.sn_valid.dtype == bool
    assert tables.sn_valid.ndim == 2
    assert tables.sn_valid.shape == (tables.n_rows, tables.n_engines)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 5000))
def test_dispatch_equals_dense_reference(seed):
    """The event-driven dispatch through MEM_E2A/MEM_S&N reproduces
    ``spikes @ W`` on assigned neurons (atol 1e-5) and nothing on the
    others; currents and stats equal the reference's dispatch."""
    rng = np.random.default_rng(seed)
    w, sol, tables, ref = _mapped_layer(rng, n_src=10, n_dest=8, m=2, n=4)
    spikes = (rng.random((6, 10)) < 0.4).astype(np.float32)
    currents, stats = dispatch_simulate(tables, spikes, 8)
    dense = spikes @ w
    assigned = sol.engine >= 0
    assert np.allclose(currents[:, assigned], dense[:, assigned], atol=1e-5)
    assert np.all(currents[:, ~assigned] == 0)
    want_currents, want_stats = ref_dispatch(ref, spikes, 8)
    np.testing.assert_array_equal(currents, want_currents)
    _assert_stats_equal(stats, want_stats)


def test_cycles_track_event_row_counts(rng):
    w, _, tables, ref = _mapped_layer(rng)
    spikes = np.zeros((3, w.shape[0]), dtype=np.float32)
    spikes[1, 2] = 1
    spikes[1, 5] = 1
    _, stats = dispatch_simulate(tables, spikes, w.shape[1])
    assert stats.cycles[0] == 0 and stats.cycles[2] == 0
    expected = max(tables.e2a_count[2], 1) + max(tables.e2a_count[5], 1)
    assert stats.cycles[1] == expected
    assert stats.events[1] == 2
    _assert_stats_equal(stats, ref_dispatch(ref, spikes, w.shape[1])[1])


def test_utilization_scales_with_activity(rng):
    w, _, tables, ref = _mapped_layer(rng, density=0.8)
    quiet = (rng.random((5, w.shape[0])) < 0.05).astype(np.float32)
    busy = (rng.random((5, w.shape[0])) < 0.6).astype(np.float32)
    u_q = mem_sn_utilization(tables, quiet, tables.n_rows)
    u_b = mem_sn_utilization(tables, busy, tables.n_rows)
    assert u_b.mean() > u_q.mean()
    np.testing.assert_array_equal(u_q, ref_util(ref, quiet, ref.n_rows))
    np.testing.assert_array_equal(u_b, ref_util(ref, busy, ref.n_rows))


def test_row_bit_width_matches_fig4(rng):
    """Fig. 4: a row is M valid bits + M log2(N) virtual-index bits + M
    waddr bits, as the reference counts it."""
    _, _, tables, ref = _mapped_layer(rng, m=3, n=4)
    m, virt_bits = 3, 2     # log2(4)
    waddr_bits = int(np.ceil(np.log2(max(tables.weight_mem.shape[1], 2))))
    assert tables.bits_per_row() == m * (1 + virt_bits + waddr_bits)
    assert tables.bits_per_row() == ref.bits_per_row()
