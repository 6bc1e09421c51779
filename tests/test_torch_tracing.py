"""The port's span tracer and flight recorder against the reference's, twin
for twin with the non-socket tests of tests/test_tracing.py: the schema
tuples, histogram percentiles, the span lifecycle, anomalies, replay
determinism and zero observer effect.  Under a VirtualClock the two
packages' ``FlightRecorder.dump_json()`` outputs are compared byte for
byte.  The port's stage spans (``tracing.span``, which the reference does
not have) are checked under a CPU ``torch.profiler``."""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_helpers import Twin, demo_models, policies
from repro.engine import FlightRecorder as RefRecorder
from repro.engine import SCENARIOS as REF_SCENARIOS
from repro.engine import run_scenario as ref_run_scenario
from repro.engine import tracing as ref_tracing

from repro_torch.core.lif import LIFParams
from repro_torch.engine import (ANOMALY_KINDS, HIST_KEYS, MLP_MODEL,
                                SCENARIOS, SPAN_KINDS, FlightRecorder,
                                Histogram, ServerMetrics, SNNTrainConfig,
                                StreamServer, VirtualClock, run_batched,
                                run_bucketed, run_scenario, trace_count)
from repro_torch.engine.snn_train import make_snn_train_step
from repro_torch.engine.tracing import (RATIO_EDGES, STAGE_SPANS, TIME_EDGES,
                                        span, stage_totals)
from repro_torch.engine.train_loop import init_train_state
from repro_torch.snn.mlp import SNNConfig

torch.set_num_threads(1)

GRID = ((2,), (8,))


@pytest.fixture(scope="module")
def models():
    return demo_models("mlp")


def _stream(t=6, seed=0, p=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((t, 64)) < p).astype(np.float32)


def _twin(models, **kw):
    """Two traced servers (reference, port) in lockstep; the recorders are
    ``twin.ref.tracer`` and ``twin.port.tracer``."""
    kw.setdefault("service_model", lambda b, t: 0.001)
    twin = Twin(*models, policy=kw.pop("policy", GRID), **kw)
    twin.ref.tracer, twin.port.tracer = RefRecorder(), FlightRecorder()
    return twin


def _same_dumps(twin):
    assert twin.port.tracer.dump_json() == twin.ref.tracer.dump_json()


# ------------------------------------------------------------ schema locks

def test_span_and_anomaly_schemas_equal_the_reference():
    assert SPAN_KINDS == ref_tracing.SPAN_KINDS
    assert ANOMALY_KINDS == ref_tracing.ANOMALY_KINDS
    assert HIST_KEYS == ref_tracing.HIST_KEYS
    assert TIME_EDGES == ref_tracing.TIME_EDGES
    assert RATIO_EDGES == ref_tracing.RATIO_EDGES
    rec = FlightRecorder()
    assert tuple(rec.hist) == HIST_KEYS
    with pytest.raises(AssertionError):
        rec.anomaly("not_a_kind", t=0.0)


# -------------------------------------------------------------- histograms

def test_histogram_percentiles_equal_the_reference():
    for edges, values in ((TIME_EDGES, (0.001, 0.002, 0.002, 0.004, 10.0,
                                        1e6, 0.0)),
                          (RATIO_EDGES, (0.1, 0.5, 0.5, 1.0))):
        h, r = Histogram(edges), ref_tracing.Histogram(edges)
        assert h.percentile(50) == 0.0 == r.percentile(50)
        for v in values:
            h.add(v)
            r.add(v)
        for q in (1, 10, 50, 90, 99, 100):
            assert h.percentile(q) == r.percentile(q)
        assert json.dumps(h.to_dict()) == json.dumps(r.to_dict())


def test_server_metrics_percentiles_from_histograms():
    m = ServerMetrics()
    m.observe_latency(5.0)
    for _ in range(m.latency_s.maxlen):
        m.observe_latency(0.001)
    snap = m.snapshot()
    assert 5.0 not in m.latency_s
    assert snap["recent_p99_latency_s"] < 0.01
    assert snap["p50_latency_s"] < 0.01
    assert m.latency_hist.n == m.latency_s.maxlen + 1


# ------------------------------------------------------------ span lifecycle

def test_trace_covers_request_lifecycle(models):
    """With every stats surface on, the two recorders' dumps — spans,
    hardware roll-ups, energy attribution, histograms — are the same
    bytes."""
    twin = _twin(models, with_stats=True)
    rid0 = twin.submit(_stream(seed=1))
    rid1 = twin.submit(_stream(seed=2))
    assert len(twin.collect()) == 2
    twin.check()
    _same_dumps(twin)
    rec = twin.port.tracer
    tr = rec.trace(rid0)
    assert tr.completed and rec.last().rid == rid1
    kinds = [sp.kind for sp in tr.spans]
    assert kinds[:6] == ["admit", "queue", "schedule", "pad", "dispatch",
                         "slice"]
    assert kinds[-1] == "complete" and "hw" in kinds
    dispatch = next(sp for sp in tr.spans if sp.kind == "dispatch")
    assert "seconds" not in dispatch.attrs
    assert dispatch.attrs["energy_j"] > 0
    assert rec.hist["latency_s"].n == 2 and rec.hist["fill"].n == 1


def test_schedule_span_says_why(models):
    twin = _twin(models)
    twin.submit(_stream(seed=1))
    twin.submit(_stream(seed=2))
    t0 = twin.port.now()
    rid = twin.submit(_stream(seed=3), slack=0.05)
    twin.advance(0.06)
    twin.poll()
    twin.check()
    _same_dumps(twin)
    rec = twin.port.tracer
    full = next(sp for sp in rec.trace(0).spans if sp.kind == "schedule")
    forced = next(sp for sp in rec.trace(rid).spans if sp.kind == "schedule")
    assert full.attrs["why"] == "full_bucket"
    assert forced.attrs["why"] == "deadline"
    assert forced.attrs["group_deadline"] == pytest.approx(t0 + 0.05)


def test_anomalies_reject_shed_miss_extension(models):
    twin = _twin(models, queue_capacity=1, backpressure="shed_oldest",
                 overlong="extend", default_slack=0.0005)
    rid0 = twin.submit(_stream(seed=1))
    twin.submit(_stream(t=12, seed=2))
    twin.flush()
    twin.check()
    _same_dumps(twin)
    c = twin.port.tracer.anomaly_counts
    assert c["shed"] == 1 and c["policy_extension"] == 1
    assert c["deadline_miss"] == 1
    tr = twin.port.tracer.trace(rid0)
    assert not tr.completed and tr.anomalies[0]["kind"] == "shed"
    twin2 = _twin(models, overlong="reject")
    twin2.submit(_stream(t=99, seed=3))
    _same_dumps(twin2)
    ev = twin2.port.tracer.events[-1]
    assert ev["kind"] == "reject" and ev["rid"] is None


# --------------------------------------------------- determinism contracts

@pytest.mark.parametrize("name", ["slo_shed", "analog_noise", "multi_tenant"])
def test_scenario_replays_byte_identical(models, name):
    """Two replays of a scenario give the same dump, and the injected
    faults all appear as typed anomalies matching the metrics.  Where the
    reference can run the scenario on its packed route (no noise, no
    perturbed swap payload), its dump is the same bytes too."""
    port = models[1]
    rec1, rec2 = FlightRecorder(), FlightRecorder()
    _, _, m1 = run_scenario(port, SCENARIOS[name], recorder=rec1)
    _, _, m2 = run_scenario(port, SCENARIOS[name], recorder=rec2)
    assert m1 == m2 and rec1.dump_json() == rec2.dump_json()
    c = rec1.anomaly_counts
    assert c.get("deadline_miss", 0) == m1["deadline_misses"]
    assert c.get("shed", 0) == m1["shed"]
    assert c.get("reject", 0) == m1["rejected"]
    assert c.get("hot_swap_pin", 0) == m1["hot_swaps"]
    flips = m1["noise_probes"] - round(m1["noise_agreement"]
                                       * m1["noise_probes"])
    assert c.get("noise_disagreement", 0) == flips
    if not (REF_SCENARIOS[name].noise_sigma or REF_SCENARIOS[name].tenants):
        ref_rec = RefRecorder()
        _, _, want = ref_run_scenario(models[0], REF_SCENARIOS[name],
                                      recorder=ref_rec)
        ref_rec.detach_jit_probe()
        assert m1 == want and rec1.dump_json() == ref_rec.dump_json()


def test_tracer_off_is_bit_exact(models):
    sc = SCENARIOS["adversarial"]
    rec = FlightRecorder()
    res_on, rids_on, m_on = run_scenario(models[1], sc, recorder=rec)
    res_off, rids_off, m_off = run_scenario(models[1], sc)
    assert m_on == m_off and rids_on == rids_off
    for rid in res_off:
        assert np.array_equal(res_on[rid].out_spikes,
                              res_off[rid].out_spikes)


def test_tracing_adds_no_new_shapes(models):
    port = models[1]
    _, port_pol = policies(*GRID)
    warm = StreamServer(port, policy=port_pol, clock=VirtualClock(),
                        service_model=lambda b, t: 0.001)
    warm.submit(_stream(seed=1))
    warm.flush()
    rec = FlightRecorder()
    n0 = trace_count()
    srv = StreamServer(port, policy=port_pol, clock=VirtualClock(),
                       service_model=lambda b, t: 0.001, tracer=rec)
    srv.submit(_stream(seed=2))
    srv.submit(_stream(seed=3))
    srv.collect()
    assert trace_count() == n0


def test_jit_probe_sees_new_shapes(models):
    """The engine's shape probe counts a first call of a new shape, and
    only the first."""
    spikes = np.stack([_stream(t=29, seed=9 + i) for i in range(3)])
    n0 = trace_count()
    run_batched(models[1], spikes)
    assert trace_count() == n0 + 1
    run_batched(models[1], spikes[::-1].copy())
    assert trace_count() == n0 + 1


# ----------------------------------------------------------- recorder edges

def test_recorder_rings_bounded_and_late_anomalies():
    recs = FlightRecorder(keep_completed=2, keep_anomalous=4), \
        RefRecorder(keep_completed=2, keep_anomalous=4)
    for rec in recs:
        for rid in range(5):
            rec.start(rid, model="m", generation=1, t=0.0)
            rec.complete(rid, 1.0)
        rec.anomaly("noise_disagreement", t=2.0, rid=4)
        rec.anomaly("noise_disagreement", t=2.5, rid=4)
        rec.span(999, "queue", 0.0, 1.0)
        rec.complete(999, 1.0)
        rec.anomaly("deadline_miss", t=3.0, rid=999)
    rec = recs[0]
    assert [t.rid for t in rec.completed] == [3, 4]
    assert [t.rid for t in rec.anomalous] == [4]
    assert len(rec.trace(4).anomalies) == 2
    assert rec.events[-1]["rid"] == 999
    assert math.isfinite(json.loads(rec.dump_json())["anomaly_counts"]
                         ["noise_disagreement"])
    assert recs[0].dump_json() == recs[1].dump_json()


# -------------------------------------------------------------- stage spans

def test_stage_spans_are_locked():
    assert STAGE_SPANS == (
        "server.dispatch", "serving.execute", "serving.pad", "engine.upload",
        "engine.forward", "engine.replay", "engine.readback", "engine.stats",
        "serving.record", "serving.slice", "train.forward", "train.backward",
        "train.optimizer", "lm.prefill", "lm.decode_step", "lm.mamba",
        "lm.shared_block")


def _stage_events(prof):
    """``(name, start_ns, end_ns)`` of a finished CPU profile's stage
    spans, outermost first where two start together."""
    evs = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in STAGE_SPANS:
            # function scope: the card's timeline carries no copy of it
            assert not ev.is_user_annotation()
            evs.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return sorted(evs, key=lambda e: (e[1], -e[2]))


def _inside(evs, outer):
    _, s, e = outer
    return [ev for ev in evs if ev is not outer and s <= ev[1] and ev[2] <= e]


@pytest.mark.parametrize("with_stats", [False, True])
def test_engine_call_holds_its_stages_in_order(models, with_stats):
    """Under a profiler, each engine call of ``run_bucketed`` is one
    ``serving.execute`` holding each stage once, one after another in the
    order the work runs; ``stage_totals`` counts them."""
    _, port_pol = policies(*GRID)
    streams = [_stream(t=t, seed=i) for i, t in enumerate((3, 7, 6, 2, 8))]
    tel = []
    before = stage_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_bucketed(models[1], streams, policy=port_pol,
                     with_stats=with_stats, telemetry=tel)
    evs = _stage_events(prof)
    calls = [ev for ev in evs if ev[0] == "serving.execute"]
    assert len(calls) == len(tel) == 3
    stages = ["serving.pad", "engine.upload", "engine.forward",
              "engine.readback", *(["engine.stats"] if with_stats else []),
              "serving.record", "serving.slice"]
    for call in calls:
        inner = _inside(evs, call)
        assert [ev[0] for ev in inner] == stages
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    assert len(evs) == len(calls) * (1 + len(stages))
    after = stage_totals()
    for name in ("serving.execute", *stages):
        assert after[name][1] - before.get(name, (0.0, 0))[1] == 3
        assert after[name][0] >= before.get(name, (0.0, 0))[0]


def test_server_dispatch_holds_the_engine_call(models):
    _, port_pol = policies(*GRID)
    srv = StreamServer(models[1], policy=port_pol, clock=VirtualClock(),
                       service_model=lambda b, t: 0.001,
                       tracer=FlightRecorder())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in range(3):
            srv.submit(_stream(seed=seed))
        srv.flush()
    evs = _stage_events(prof)
    disp = [ev for ev in evs if ev[0] == "server.dispatch"]
    assert len(disp) == len(srv.telemetry) == 2
    for d in disp:
        assert [ev[0] for ev in _inside(evs, d)][0] == "serving.execute"
        assert sum(ev[0] == "serving.execute" for ev in _inside(evs, d)) == 1


def test_train_step_holds_forward_backward_optimizer():
    cfg = SNNConfig(layer_sizes=(16, 8, 4), lif=LIFParams(), num_steps=4)
    opt = SNNTrainConfig(lr=1e-3).adamw()
    step = make_snn_train_step(MLP_MODEL, cfg, opt)
    gen = torch.Generator().manual_seed(0)
    params = MLP_MODEL.init(gen, cfg, device="cpu")
    state = init_train_state(None, params, opt).as_tree()
    batch = {"spikes": (torch.rand(4, 6, 16, generator=gen) < 0.3).float(),
             "labels": torch.arange(6) % 4}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert [ev[0] for ev in _stage_events(prof)] == [
        "train.forward", "train.backward", "train.optimizer"]


def test_span_without_a_profiler_is_the_shared_no_op():
    off = span("engine.upload")
    assert off is span("train.forward")
    with off as got:
        assert got is None
    ticks = iter((1.0, 2.5))
    with span("serving.pad", lambda: next(ticks)) as sp:
        pass
    assert (sp.t0, sp.t1) == (1.0, 2.5)


def test_profiled_replay_dumps_the_same_bytes(models):
    """A tracer-on VirtualClock replay under a profiler dumps the bytes of
    the same replay without one: the stage spans share the server clock's
    reads and add none to the trace."""
    sc = SCENARIOS["slo_shed"]
    plain = FlightRecorder()
    run_scenario(models[1], sc, recorder=plain)
    traced = FlightRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        run_scenario(models[1], sc, recorder=traced)
    assert traced.dump_json() == plain.dump_json()
