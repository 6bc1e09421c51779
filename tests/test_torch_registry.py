"""The port's multi-tenant fabric against the reference's, twin for twin
with the non-socket tests of tests/test_multitenant.py: registry semantics,
routing, per-tenant isolation, generation-pinned hot-swap and the per-model
metrics — each serving twin driving the reference's server (packed route)
and the port's (CPU) in lockstep and holding them equal
(``_torch_helpers.Twin``)."""

import numpy as np
import pytest
import torch

from _torch_helpers import Twin, demo_models
from repro.engine import ModelRegistry as RefRegistry
from repro.engine import SCENARIOS as REF_SCENARIOS
from repro.engine import run_scenario as ref_run_scenario
from repro.engine import chaos as ref_chaos

from repro_torch.engine import (DEFAULT_MODEL, METRIC_KEYS, PER_MODEL_KEYS,
                                BucketPolicy, ModelRegistry, ServerMetrics,
                                StreamServer, UnknownModelError,
                                VirtualClock, run_batched, run_scenario,
                                serve_trace, swap_model_for, trace_count)

torch.set_num_threads(1)

GRID = ((1, 2, 4), (4, 8))


@pytest.fixture(scope="module")
def models():
    """Three tenants as (reference, port) pairs: a (64 -> 48 -> 10), a2 of
    the same shapes with other weights, b the conv demo (72 inputs)."""
    return {"a": demo_models("mlp", seed=0), "a2": demo_models("mlp", seed=1),
            "b": demo_models("conv", seed=2)}


def _policy():
    return BucketPolicy(batch_sizes=GRID[0], time_steps=GRID[1])


def _streams(rng, n_in, lengths, p=0.35):
    return [(rng.random((t, n_in)) < p).astype(np.float32) for t in lengths]


def _registries(models, **kw):
    from _torch_helpers import policies
    ref_pol, port_pol = policies(*GRID)
    ref, port = RefRegistry(), ModelRegistry(device="cpu")
    for name, key in (("alpha", "a"), ("beta", "b")):
        ref.register(name, models[key][0], policy=ref_pol, **kw)
        port.register(name, models[key][1], policy=port_pol, **kw)
    return ref, port


def _ref(packed, stream):
    return run_batched(packed, stream[None],
                       with_stats=False).out_spikes[0][:stream.shape[0]]


# ---------------------------------------------------------------- registry

def test_registry_register_get_default(models):
    _, reg = _registries(models)
    a, b = models["a"][1], models["b"][1]
    assert len(reg) == 2 and set(reg.names()) == {"alpha", "beta"}
    assert "alpha" in reg and "gamma" not in reg
    assert reg.get("beta").packed is b
    assert reg.default == "alpha" and reg.get().packed is a
    assert reg.get(None).name == "alpha"
    reg2 = ModelRegistry(default="beta")
    reg2.register("alpha", a, policy=_policy())
    reg2.register("beta", b, policy=_policy())
    assert reg2.get().name == "beta"


def test_registry_unknown_model_error_is_typed_and_names_known(models):
    ref, reg = _registries(models)
    with pytest.raises(UnknownModelError) as ei:
        reg.get("gamma")
    assert ei.value.name == "gamma" and set(ei.value.known) == {"alpha",
                                                                "beta"}
    with pytest.raises(KeyError) as er:
        ref.get("gamma")
    assert str(ei.value) == str(er.value)
    with pytest.raises(UnknownModelError):
        ModelRegistry().get()


def test_registry_refuses_duplicates_and_empty_names(models):
    a = models["a"][1]
    reg = ModelRegistry()
    reg.register("alpha", a, policy=_policy())
    with pytest.raises(ValueError, match="swap"):
        reg.register("alpha", a, policy=_policy())
    with pytest.raises(ValueError):
        reg.register("", a, policy=_policy())
    with pytest.raises(ValueError):
        reg.register("x", a, policy=_policy(), weight=0.0)


def test_registry_swap_bumps_generation_and_inherits(models):
    a, a2 = models["a"][1], models["a2"][1]
    reg = ModelRegistry()
    reg.register("alpha", a, policy=_policy(), weight=2.5)
    e1 = reg.get("alpha")
    e2 = reg.swap("alpha", a2)
    assert (e1.generation, e2.generation) == (1, 2) and e2.packed is a2
    assert e2.weight == 2.5 and e2.policy == e1.policy
    assert reg.get("alpha") is e2
    with pytest.raises(UnknownModelError):
        reg.swap("gamma", a2)


def test_registry_packs_mapped_models():
    """A mapped model is packed onto the registry's device; with no card,
    the default device raises rather than falling back."""
    from repro_torch.launch.serve_snn import build_demo_model
    mapped = build_demo_model("mlp", smoke=True)
    entry = ModelRegistry(device="cpu").register("m", mapped,
                                                 policy=_policy())
    assert entry.packed.n_in == 64 and entry.packed.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelRegistry().register("m", mapped, policy=_policy())


# ----------------------------------------------------------------- routing

def test_routing_bit_exact_across_interleaved_tenants(rng, models):
    twin = Twin(*_registries(models), with_stats=False)
    sa, sb = _streams(rng, 64, [3, 7, 5, 8]), _streams(rng, 72, [4, 6, 2, 8])
    rids = []
    for a, b in zip(sa, sb):
        rids.append(("a", a, twin.submit(a, model="alpha")))
        rids.append(("b", b, twin.submit(b, model="beta")))
    done = dict(twin.flush())
    twin.check()
    for key, s, rid in rids:
        assert np.array_equal(done[rid].out_spikes, _ref(models[key][1], s))
    snap = twin.port.metrics.snapshot()
    assert snap["models"] == 2
    assert snap["per_model"]["alpha"]["completed"] == len(sa)


def test_submit_unknown_model_raises_before_side_effects(rng, models):
    server = StreamServer(_registries(models)[1], clock=VirtualClock())
    with pytest.raises(UnknownModelError, match="gamma"):
        server.submit(_streams(rng, 64, [4])[0], model="gamma")
    snap = server.metrics.snapshot()
    assert snap["submitted"] == 0 and snap["rejected"] == 0


def test_bad_shape_error_names_the_tenant(rng, models):
    server = StreamServer(_registries(models)[1], clock=VirtualClock())
    with pytest.raises(ValueError, match="beta"):
        server.submit(_streams(rng, 64, [4])[0], model="beta")


def test_single_tenant_constructor_still_works(rng, models):
    a = models["a"][1]
    server = StreamServer(a, policy=_policy(), clock=VirtualClock())
    assert server.registry.default == DEFAULT_MODEL and server.packed is a
    s = _streams(rng, 64, [5])[0]
    rid = server.submit(s)
    assert np.array_equal(dict(server.flush())[rid].out_spikes, _ref(a, s))


# ------------------------------------------------------ per-tenant isolation

def test_ewma_keyed_by_model_and_cleared_per_tenant(rng, models):
    twin = Twin(*_registries(models))
    for s in _streams(rng, 64, [3, 7]):
        twin.submit(s, model="alpha")
    for s in _streams(rng, 72, [3, 7]):
        twin.submit(s, model="beta")
    twin.flush()
    # the EWMA values are wall seconds; their keys are the contract
    assert set(twin.port._ewma) == set(twin.ref._ewma)
    assert {k[0] for k in twin.port._ewma} == {"alpha", "beta"}
    twin.port.clear_service_estimates("alpha")
    assert {k[0] for k in twin.port._ewma} == {"beta"}
    twin.port.clear_service_estimates()
    assert twin.port._ewma == {}


def test_shed_oldest_targets_the_flooding_tenant(rng, models):
    twin = Twin(*_registries(models), queue_capacity=4,
                backpressure="shed_oldest", service_model=lambda b, t: 0.001)
    quiet = twin.submit(_streams(rng, 64, [5])[0], model="alpha")
    flood = [twin.submit(s, model="beta")
             for s in _streams(rng, 72, [5] * 7)]
    done = dict(twin.flush())
    twin.check()
    assert quiet in done and flood.count(None) == 0
    shed = [r for r in twin.port.rejections if r.reason == "shed"]
    assert shed and all(r.model == "beta" for r in shed)


def test_burst_does_not_starve_other_tenants_deadlines(rng, models):
    twin = Twin(*_registries(models), queue_capacity=64,
                service_model=lambda b, t: 0.004)
    trace = [(0.0, s, None, "beta") for s in _streams(rng, 72, [8] * 12)]
    trace += [(0.001 * (i + 1), s, 0.001 * (i + 1) + 0.05, "alpha")
              for i, s in enumerate(_streams(rng, 64, [4, 4, 4]))]
    trace.sort(key=lambda e: e[0])
    twin.serve_trace(trace)
    twin.check()
    alpha = twin.port.metrics.snapshot()["per_model"]["alpha"]
    assert alpha["completed"] == 3 and alpha["deadline_misses"] == 0


# ---------------------------------------------------------------- hot-swap

def test_hot_swap_under_live_traffic_is_bit_exact(rng, models):
    twin = Twin(*_registries(models), with_stats=False,
                service_model=lambda b, t: 0.002)
    swap_t = 0.05
    pre = [(0.01 * i, s, None, "alpha")
           for i, s in enumerate(_streams(rng, 64, [3, 7, 5]))]
    post = [(swap_t + 0.01 * (i + 1), s, None, "alpha")
            for i, s in enumerate(_streams(rng, 64, [5, 3, 8]))]
    other = [(0.015 + 0.02 * i, s, None, "beta")
             for i, s in enumerate(_streams(rng, 72, [4, 6, 5]))]
    trace = sorted(pre + post + other, key=lambda e: e[0])
    from repro.engine import serve_trace as ref_serve_trace
    ref_res, ref_rids = ref_serve_trace(
        twin.ref, trace,
        control=[(swap_t, lambda s: s.swap("alpha", models["a2"][0]))])
    results, rids = serve_trace(
        twin.port, trace,
        control=[(swap_t, lambda s: s.swap("alpha", models["a2"][1]))])
    twin.done_ref.update(ref_res)
    twin.done_port.update(results)
    assert rids == ref_rids and None not in rids
    twin.check()
    for (t_a, s, _, name), rid in zip(trace, rids):
        live = {"beta": "b"}.get(name, "a" if t_a < swap_t else "a2")
        assert np.array_equal(results[rid].out_spikes,
                              _ref(models[live][1], s))
    snap = twin.port.metrics.snapshot()
    assert snap["hot_swaps"] == 1 and snap["per_model"]["beta"][
        "hot_swaps"] == 0
    assert twin.port.registry.get("alpha").generation == 2


def test_swap_does_not_eat_uncollected_results(rng, models):
    a, a2 = models["a"][1], models["a2"][1]
    server = StreamServer(a, policy=_policy(), clock=VirtualClock())
    early = [server.submit(s) for s in _streams(rng, 64, [4] * 4)]
    late = server.submit(_streams(rng, 64, [6])[0])
    server.swap(DEFAULT_MODEL, a2)
    assert set(early + [late]) <= set(dict(server.collect()))


def test_same_shape_swap_adds_no_new_shapes(rng, models):
    a, a2 = models["a"][1], models["a2"][1]
    server = StreamServer(a, policy=_policy(), clock=VirtualClock())
    for s in _streams(rng, 64, [3, 7]):
        server.submit(s)
    server.flush()
    n0 = trace_count()
    server.swap(DEFAULT_MODEL, a2)
    for s in _streams(rng, 64, [3, 7]):
        server.submit(s)
    server.flush()
    assert trace_count() == n0


# ------------------------------------------------------------ metrics schema

def test_per_model_metrics_schema_locked():
    from repro.engine import ServerMetrics as RefMetrics
    m, r = ServerMetrics(), RefMetrics()
    assert m.model("x").snapshot() == r.model("x").snapshot()
    assert tuple(m.model("x").snapshot()) == PER_MODEL_KEYS
    assert m.snapshot() == r.snapshot()
    assert tuple(m.snapshot()) == METRIC_KEYS


# ----------------------------------------------------------- chaos scenario

def test_multi_tenant_scenario_twin(models, monkeypatch):
    """The multi-tenant soak script on both fabrics.  The reference cannot
    perturb a packed-operand model, so its swap payload is the other
    weights of the same shapes; scheduling does not read weights, so the
    dispatch sequence and every metric still agree, and each fabric's
    post-swap results equal its own swapped model."""
    ref_a, port_a = models["a"]
    monkeypatch.setattr(ref_chaos, "swap_model_for",
                        lambda packed, sc: models["a2"][0])
    sc = REF_SCENARIOS["multi_tenant"]
    _, _, want = ref_run_scenario(ref_a, sc)
    from repro_torch.engine import SCENARIOS
    got_res, rids, got = run_scenario(port_a, SCENARIOS["multi_tenant"])
    assert got == want
    assert got["hot_swaps"] == 1 and got["served_all_admitted"]
    assert got["per_model"]["steady"]["deadline_miss_rate"] <= 0.05
    swapped = swap_model_for(port_a, SCENARIOS["multi_tenant"])
    again = swap_model_for(port_a, SCENARIOS["multi_tenant"])
    for la, lb, l0 in zip(swapped.layers, again.layers, port_a.layers):
        assert torch.equal(la.w_fused, lb.w_fused)
        assert not torch.equal(la.w_fused, l0.w_fused)
