"""The port's data-parallel sharded engine (``repro_torch.engine.
sharded_run``): twins of tests/test_sharded_engine.py.

``run_sharded`` over a spoofed mesh (``snn_serve_mesh(spoof=N)``: N logical
shards of the CPU, in this process) must equal the port's ``run_batched``
bit for bit on every surface — spikes, DispatchStats, utilization,
overflow, energy — and, through it, the reference's numpy oracle
(``repro.core.accelerator.run_batch``).  The reference's own sharded path
does not run on the installed JAX (its ``shard_map`` call passes
``check_rep``), so the port is held to its single-device path, the oracle,
and the reference's mesh-free rule helpers, which a subprocess runs on a
spoofed 8-device XLA host."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings
from _torch_helpers import (STAT_FIELDS, assert_batched_equals_oracle,
                            case_layers, map_both, spikes_for)
from repro.core.accelerator import run_batch
from test_equivalence_prop import conv_cases, dense_cases

from repro_torch.engine import batched_run as br
from repro_torch.engine import (BucketPolicy, DeviceLossError, batch_spec,
                                n_batch_shards, run_sharded, shrink_mesh,
                                snn_serve_mesh)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DENSE_CASE = {"seed": 3, "in_shape": [14, 1, 1],
              "layers": [{"kind": "dense", "n_out": 12, "density": 0.6},
                         {"kind": "dense", "n_out": 6, "density": 0.8}],
              "batch": 4, "t": 6, "p_spike": 0.35, "max_events": None,
              "n_engines": 3, "n_caps": 5, "beta": 0.8, "threshold": 0.7}

CONV_CASE = {"seed": 5, "in_shape": [2, 6, 6],
             "layers": [{"kind": "conv", "c_out": 2, "k": 3, "stride": 1,
                         "padding": 1, "density": 0.6},
                        {"kind": "pool", "pool": 2},
                        {"kind": "dense", "n_out": 5, "density": 0.7}],
             "batch": 4, "t": 5, "p_spike": 0.25, "max_events": None,
             "n_engines": 3, "n_caps": 6, "beta": 0.8, "threshold": 0.7}


def build_both(case):
    """(reference mapped model, port model packed for the CPU, spikes) of
    a golden-equivalence case, drawn as tests/test_equivalence_prop.py::
    build_case draws it."""
    rng = np.random.default_rng(case["seed"])
    layers = case_layers(case, rng)
    ref, port = map_both(layers, case["n_engines"], case["n_caps"],
                         beta=case["beta"], threshold=case["threshold"],
                         quant_bits=case.get("quant_bits", 8),
                         compress=bool(case.get("compress", False)))
    spikes = spikes_for(rng, case["batch"], case["t"],
                        port.layers[0].n_src, case["p_spike"])
    return ref, port.pack(device="cpu"), spikes


def mesh(n):
    return snn_serve_mesh(device="cpu", spoof=n)


def assert_results_equal(a, b, tag=""):
    """Two port BatchedRunResults, every surface bit for bit (the
    reference's _equivalence.assert_engine_results_equal)."""
    np.testing.assert_array_equal(a.out_spikes, b.out_spikes,
                                  err_msg=f"{tag} spikes")
    assert len(a.per_layer_stats) == len(b.per_layer_stats), tag
    for li, (sa, sb) in enumerate(zip(a.per_layer_stats, b.per_layer_stats)):
        for f in (*STAT_FIELDS, "mem_e_peak"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                          err_msg=f"{tag} layer {li} {f}")
    for li in range(len(a.per_layer_util)):
        np.testing.assert_array_equal(a.per_layer_util[li],
                                      b.per_layer_util[li])
        np.testing.assert_array_equal(a.overflow[li], b.overflow[li])
    if a.spec is not None and a.per_layer_stats:
        for s in range(a.out_spikes.shape[0]):
            assert a.sample_energy(s) == b.sample_energy(s), f"{tag} {s}"


def check(case, n, cap=None, tag=""):
    """run_sharded on an n-way spoofed mesh == run_batched == the oracle."""
    ref, packed, spikes = build_both(case)
    a = run_sharded(packed, spikes, mesh=mesh(n), max_events=cap)
    assert_results_equal(a, br.run_batched(packed, spikes, max_events=cap),
                         f"{tag} n={n} cap={cap}")
    assert_batched_equals_oracle(
        a, run_batch(ref, spikes, max_events=cap), len(packed.layers),
        f"{tag} n={n} cap={cap}")
    return a


# ------------------------------------------------- in-process (any mesh)

@pytest.mark.parametrize("case,cap", [
    (DENSE_CASE, None), (DENSE_CASE, 3), (CONV_CASE, None), (CONV_CASE, 4)])
def test_sharded_matches_batched(case, cap):
    """1-, 2-, 3- (replicated: 4 does not split 3 ways) and 4-way meshes."""
    for n in (1, 2, 3, 4):
        check(case, n, cap)


def test_sharded_matches_oracle_transitively():
    """The chain closes: sharded == batched == numpy oracle, on the
    default-size mesh of the reference's test (every device there: one
    CPU here) and on a 2-way one."""
    ref, packed, spikes = build_both(DENSE_CASE)
    assert_batched_equals_oracle(br.run_batched(packed, spikes),
                                 run_batch(ref, spikes), 2)
    default = snn_serve_mesh(device="cpu")
    assert default.size == 1
    for m in (default, mesh(2)):
        assert_results_equal(run_sharded(packed, spikes, mesh=m),
                             br.run_batched(packed, spikes))


def test_sharded_empty_batch():
    _, packed, spikes = build_both(DENSE_CASE)
    res = run_sharded(packed, spikes[:0], mesh=mesh(2))
    assert res.out_spikes.shape == (0, spikes.shape[1],
                                    packed.layers[-1].n_dest)
    assert all(s.cycles.shape[0] == 0 for s in res.per_layer_stats)


def test_batch_spec_rules():
    """The SNN serving rule shards only the batch axis, and replicates a
    batch the mesh does not divide."""
    for n in (1, 2, 8):
        m = mesh(n)
        spec = batch_spec(m, (4 * n, 7, 13))
        assert spec == ("data", None, None)
        assert n_batch_shards(m, 4 * n) == n
        if n > 1:
            assert batch_spec(m, (4 * n + 1, 7, 13))[0] is None
            assert n_batch_shards(m, 4 * n + 1) == 1   # graceful degradation
        else:
            assert n_batch_shards(m, 5) == 1


def test_sharded_trace_count_shared_probe():
    """run_sharded bumps the same trace_count() probe as run_batched: a
    sharded shape counts once, a repeat of it not again, and the same
    shape through run_batched once more."""
    _, packed, spikes = build_both(DENSE_CASE)
    m = mesh(2)
    n0 = br.trace_count()
    run_sharded(packed, spikes, mesh=m, max_events=5)
    assert br.trace_count() == n0 + 1
    run_sharded(packed, spikes, mesh=m, max_events=5)
    assert br.trace_count() == n0 + 1
    br.run_batched(packed, spikes, max_events=5)
    assert br.trace_count() == n0 + 2


@settings(max_examples=25, deadline=None)
@given(case=dense_cases())
def test_prop_sharded_dense(case):
    """Property: run_sharded on a spoofed mesh of ``batch`` shards (one
    sample each) == run_batched == the oracle for random dense stacks."""
    check(case, case["batch"], case.get("max_events"))


@settings(max_examples=15, deadline=None)
@given(case=conv_cases())
def test_prop_sharded_conv(case):
    """Property: sharded == batched == oracle for random conv/pool/dense
    stacks."""
    check(case, case["batch"], case.get("max_events"))


# ------------------------------------------- spoofed multi-device acceptance

def test_sharded_8dev_bit_exact():
    """Dense + conv + capped models on a spoofed 8-way mesh: the batch
    really splits 8 ways and every surface stays bit-exact."""
    m = mesh(8)
    for case, cap in [(DENSE_CASE, None), (DENSE_CASE, 2),
                      (CONV_CASE, None), (CONV_CASE, 3)]:
        case = dict(case, batch=8)
        assert n_batch_shards(m, case["batch"]) == 8
        check(case, 8, cap, "8dev")


def test_sharded_8dev_nondivisible_graceful():
    """B=6 on an 8-way mesh cannot split: the rule degrades to replicated
    execution and the result is still bit-exact."""
    assert n_batch_shards(mesh(8), 6) == 1
    check(dict(DENSE_CASE, batch=6), 8)


def test_spoofed_shards_keep_their_own_input_buffers():
    """Each shard of a spoofed mesh refills its own input buffer (keyed by
    shard), never one another's; a lost device's shards drop theirs, and
    the unsharded call's ``(B, T)`` buffer stays."""
    _, packed, spikes = build_both(dict(DENSE_CASE, batch=8))
    a = run_sharded(packed, spikes, mesh=mesh(4))
    assert sorted(packed.input_buffers) == [(s, 2, 6) for s in range(4)]
    bufs = [packed.input_buffers[(s, 2, 6)] for s in range(4)]
    assert len({b.data_ptr() for b in bufs}) == 4
    assert_results_equal(a, br.run_batched(packed, spikes))
    packed.drop_devices(mesh(2).devices, 2)
    assert sorted(packed.input_buffers) == [(0, 2, 6), (1, 2, 6), (8, 6)]


def test_mesh_constructors_refuse_what_is_not_there():
    """More real devices than exist, or more shards than spoofed, raise;
    shrinking keeps the first devices and raises past the last."""
    with pytest.raises(ValueError, match="2-way mesh"):
        snn_serve_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="3-way mesh over 2 spoofed"):
        snn_serve_mesh(3, device="cpu", spoof=2)
    m = snn_serve_mesh(3, device="cpu", spoof=4)
    assert (m.size, m.shape, m.real) == (3, {"data": 3}, False)
    assert snn_serve_mesh(device="cpu").real
    assert shrink_mesh(m, 2).size == 1
    with pytest.raises(DeviceLossError, match="all 3 devices lost"):
        shrink_mesh(m, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snn_serve_mesh(2)


# ---------------------------- the rule helpers against the reference's

_RULES_SCRIPT = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.engine.serving import BucketPolicy
from repro.engine.sharded_run import (DeviceLossError, batch_spec,
                                      n_batch_shards, shrink_mesh)

assert len(jax.devices()) == 8
out = {}
for n in range(1, 9):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    shrunk = []
    for lost in range(1, n + 1):
        try:
            shrunk.append(shrink_mesh(mesh, lost).size)
        except DeviceLossError:
            shrunk.append(0)
    out[n] = {
        "shards": [n_batch_shards(mesh, b) for b in range(25)],
        "spec": [[a if a is None or isinstance(a, str) else list(a)
                  for a in batch_spec(mesh, (b, 3, 5))] for b in range(25)],
        "shrink": shrunk,
        "for_mesh": [list(BucketPolicy.for_mesh(n, batch_sizes=bs,
                                                time_steps=ts).batch_sizes)
                     for bs, ts in (((1, 4, 16), (8, 16, 32)),
                                    ((2, 3, 5, 7), (4,)))],
        "covering": [[list(p.batch_sizes), list(p.time_steps)]
                     for p in (BucketPolicy.covering(ls, n_shards=n,
                                                     max_batch=mb)
                               for ls, mb in (([3, 9, 17], 16),
                                              ([1], 4), ([30, 8], 4 * n),
                                              ([5, 64, 2], 7)))],
    }
print("RULES" + json.dumps(out))
"""


def test_rule_helpers_match_the_reference_on_8_spoofed_devices():
    """The reference's n_batch_shards, batch_spec, shrink_mesh, for_mesh
    and covering(n_shards=) on a spoofed 8-device XLA host (meshes of 1 to
    8 devices, batches 0 to 24) against the port's on spoofed meshes."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", _RULES_SCRIPT],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-4000:])
    ref = json.loads(p.stdout.split("RULES", 1)[1])
    for n in range(1, 9):
        m = mesh(n)
        want = ref[str(n)]
        assert [n_batch_shards(m, b) for b in range(25)] == want["shards"]
        assert [list(batch_spec(m, (b, 3, 5))) for b in range(25)] \
            == want["spec"]
        shrunk = []
        for lost in range(1, n + 1):
            try:
                shrunk.append(shrink_mesh(m, lost).size)
            except DeviceLossError:
                shrunk.append(0)
        assert shrunk == want["shrink"]
        assert [list(BucketPolicy.for_mesh(n, batch_sizes=bs,
                                           time_steps=ts).batch_sizes)
                for bs, ts in (((1, 4, 16), (8, 16, 32)),
                               ((2, 3, 5, 7), (4,)))] == want["for_mesh"]
        got = [[list(q.batch_sizes), list(q.time_steps)]
               for q in (BucketPolicy.covering(ls, n_shards=n, max_batch=mb)
                         for ls, mb in (([3, 9, 17], 16), ([1], 4),
                                        ([30, 8], 4 * n), ([5, 64, 2], 7)))]
        assert got == want["covering"]
