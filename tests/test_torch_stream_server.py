"""The port's always-on StreamServer against the reference's, twin for twin
with tests/test_stream_server.py.

Each twin drives the reference's server (on its packed-operand route, the
route its Pallas kernels run on the installed JAX) and the port's (on the
CPU) with the same trace on their own VirtualClocks and a fixed
``service_model``, then holds them equal (``_torch_helpers.Twin.check``):
the dispatch sequence (every telemetry field but the wall ``seconds``),
the rejections and their reasons, every ``ServerMetrics.snapshot()`` key,
and every served result bit for bit.  The reference test's own assertions
are kept on the port's side.
"""

import math
import time

import numpy as np
import pytest
import torch

from _torch_helpers import Twin, assert_results_equal, demo_models, policies
from repro.engine import METRIC_KEYS as REF_METRIC_KEYS
from repro.engine import PER_MODEL_KEYS as REF_PER_MODEL_KEYS
from repro.engine import run_bucketed as ref_run_bucketed

from repro_torch.engine import (METRIC_KEYS, PER_MODEL_KEYS, BucketPolicy,
                                StreamServer, VirtualClock, WallClock,
                                run_bucketed, serve_trace, should_donate,
                                trace_count)
from repro_torch.engine import serving as serving_mod

torch.set_num_threads(1)

N_IN = 64                 # the serve_snn smoke MLP: 64 -> 48 -> 10
GRID = ((1, 2, 4), (4, 8))


@pytest.fixture(scope="module")
def models():
    return demo_models("mlp")


def _streams(rng, lengths, p=0.35):
    return [(rng.random((t, N_IN)) < p).astype(np.float32) for t in lengths]


def _policy():
    return BucketPolicy(batch_sizes=GRID[0], time_steps=GRID[1])


def test_schemas_equal_the_reference():
    assert METRIC_KEYS == REF_METRIC_KEYS
    assert PER_MODEL_KEYS == REF_PER_MODEL_KEYS


# ------------------------------------------------ bit-exactness vs bucketed

def test_async_matches_bucketed_deterministic(rng, models):
    """Both servers serve a trace with every result surface; the port's
    results equal the reference server's, the port's closed-list run and
    the reference's closed-list run, bit for bit."""
    ref_m, port_m = models
    streams = _streams(rng, [3, 7, 5, 8, 2, 8, 1])
    twin = Twin(ref_m, port_m, policy=GRID, with_stats=True)
    results, rids = twin.serve_trace([(0.05 * i, s)
                                      for i, s in enumerate(streams)])
    assert rids == list(range(len(streams)))
    twin.check()
    mine = run_bucketed(port_m, streams, policy=_policy())
    ref = ref_run_bucketed(ref_m, streams, policy=policies(*GRID)[0])
    for i in range(len(streams)):
        assert_results_equal(results[rids[i]], mine[i], f"req {i}")
        assert_results_equal(results[rids[i]], ref[i], f"req {i}")
    assert twin.port.metrics.snapshot()["completed"] == len(streams)


def test_async_matches_under_max_events(rng, models):
    """The MEM_E cap threads through both async paths identically."""
    streams = _streams(rng, [3, 6, 5], p=0.7)
    twin = Twin(*models, policy=GRID, with_stats=True, max_events=2)
    results, rids = twin.serve_trace([(0.0, s) for s in streams])
    twin.check()
    want = run_bucketed(models[1], streams, policy=_policy(), max_events=2)
    for i in range(len(streams)):
        assert_results_equal(results[rids[i]], want[i], f"req {i}")


@pytest.mark.parametrize("seed", range(6))
def test_async_random_traces(models, seed):
    """Random lengths, inter-arrival gaps, and finite/infinite deadlines:
    the two servers agree on everything, and every result equals the
    closed-list run (the reference's property test, over fixed seeds)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    lengths = [int(t) for t in rng.integers(1, 9, n)]
    gaps = rng.uniform(0.0, 0.4, n)
    slacks = rng.choice([0.05, 0.3, math.inf], n)
    streams = _streams(rng, lengths)
    trace = [(float(t), s, float(t) + float(sl))
             for t, s, sl in zip(np.cumsum(gaps), streams, slacks)]
    twin = Twin(*models, policy=GRID, service_model=lambda b, t: 0.01)
    results, rids = twin.serve_trace(trace)
    twin.check()
    closed = run_bucketed(models[1], streams, policy=_policy(),
                          with_stats=False)
    assert None not in rids
    for i in range(n):
        np.testing.assert_array_equal(results[rids[i]].out_spikes,
                                      closed[i].out_spikes)


# ------------------------------------------------------- deadline pressure

def test_deadline_forces_partial_dispatch(rng, models):
    twin = Twin(*models, policy=((4,), (8,)),
                service_model=lambda b, t: 0.1)
    streams = _streams(rng, [5, 6, 3])
    n0 = trace_count()
    twin.serve_trace([(0.0, streams[0], 1.0), (0.05, streams[1], 1.05),
                      (50.0, streams[2], 51.0)])
    twin.check()
    snap = twin.port.metrics.snapshot()
    assert snap["forced_dispatches"] >= 1 and snap["deadline_misses"] == 0
    assert 0.5 in twin.port.metrics.fill
    assert trace_count() - n0 <= 1
    assert max(list(twin.port.metrics.ttfd_s)[:2]) < 1.0


def test_tight_deadline_behind_best_effort_request(rng, models):
    twin = Twin(*models, policy=((4,), (8,)),
                service_model=lambda b, t: 0.1)
    streams = _streams(rng, [5, 6])
    twin.submit(streams[0])
    twin.submit(streams[1], slack=1.0)
    assert twin.port.next_deadline() == pytest.approx(0.9) \
        == twin.ref.next_deadline()
    twin.advance(0.9)
    assert len(twin.poll()) == 2 and twin.port.queue_depth == 0
    twin.check()
    snap = twin.port.metrics.snapshot()
    assert snap["forced_dispatches"] == 1 and snap["deadline_misses"] == 0


def test_full_bucket_dispatches_immediately(rng, models):
    twin = Twin(*models, policy=((2,), (8,)))
    for s in _streams(rng, [4, 6]):
        twin.submit(s)
    assert len(twin.collect()) == 2 and twin.port.queue_depth == 0
    twin.check()
    snap = twin.port.metrics.snapshot()
    assert snap["dispatches"] == 1 and snap["forced_dispatches"] == 0
    assert snap["bucket_fill_ratio"] == pytest.approx(1.0)


def test_infinite_slack_waits_for_flush(rng, models):
    twin = Twin(*models, policy=GRID)
    twin.submit(_streams(rng, [5])[0])
    assert twin.port.next_deadline() is None is twin.ref.next_deadline()
    assert twin.poll() == [] and twin.port.queue_depth == 1
    assert len(twin.flush()) == 1 and twin.port.queue_depth == 0
    twin.check()


# ----------------------------------------------------------- backpressure

def test_backpressure_reject(rng, models):
    twin = Twin(*models, policy=GRID, queue_capacity=2,
                backpressure="reject")
    rids = [twin.submit(s) for s in _streams(rng, [3, 3, 3])]
    assert rids[2] is None and None not in rids[:2]
    assert twin.port.rejections[-1].reason == "queue_full"
    assert len(twin.flush()) == 2
    twin.check()


def test_backpressure_shed_oldest(rng, models):
    twin = Twin(*models, policy=GRID, queue_capacity=2,
                backpressure="shed_oldest")
    rids = [twin.submit(s) for s in _streams(rng, [3, 3, 3])]
    assert twin.port.rejections[-1].reason == "shed"
    assert twin.port.rejections[-1].rid == rids[0]
    assert set(dict(twin.flush())) == {rids[1], rids[2]}
    twin.check()
    snap = twin.port.metrics.snapshot()
    assert snap["shed"] == 1 and snap["completed"] == 2


# ------------------------------------------------------ admission control

def test_overlong_rejected_at_admission(rng, models):
    twin = Twin(*models, policy=((2,), (4,)))
    assert twin.submit(_streams(rng, [4])[0]) is not None
    assert twin.submit(_streams(rng, [9])[0]) is None
    assert twin.port.rejections[-1].reason == "overlong"
    assert "9 steps" in twin.port.rejections[-1].detail
    assert len(twin.flush()) == 1
    twin.check()


def test_overlong_extends_grid(rng, models):
    twin = Twin(*models, policy=((2,), (4,)), overlong="extend")
    stream = _streams(rng, [9])[0]
    rid = twin.submit(stream)
    assert twin.port.policy.time_steps == (4, 16) \
        == twin.ref.policy.time_steps
    done = dict(twin.flush())
    twin.check()
    assert twin.port.metrics.snapshot()["policy_extensions"] == 1
    want = run_bucketed(models[1], [stream], policy=twin.port.policy,
                        with_stats=False)[0]
    np.testing.assert_array_equal(done[rid].out_spikes, want.out_spikes)


def test_overlong_rejected_by_backpressure_leaves_grid_alone(rng, models):
    twin = Twin(*models, policy=((2,), (4,)), overlong="extend",
                queue_capacity=1)
    assert twin.submit(_streams(rng, [3])[0]) is not None
    assert twin.submit(_streams(rng, [9])[0]) is None
    assert twin.port.rejections[-1].reason == "queue_full"
    assert twin.port.policy.time_steps == (4,)
    twin.check()


def test_empty_stream_rejected(models):
    twin = Twin(*models, policy=GRID)
    assert twin.submit(np.zeros((0, N_IN), np.float32)) is None
    assert twin.port.rejections[-1].reason == "empty"
    twin.check()


def test_submit_bad_width_raises_typed_error(models):
    server = StreamServer(models[1], policy=_policy(), clock=VirtualClock())
    with pytest.raises(ValueError, match=f"expected \\[T, {N_IN}\\]"):
        server.submit(np.zeros((4, N_IN + 1), np.float32))


def test_rejection_callback_sees_every_rejection(rng, models):
    seen_port, seen_ref = [], []
    from repro.engine import StreamServer as RefServer
    from repro.engine import VirtualClock as RefClock
    ref_pol, port_pol = policies(*GRID)
    ref = RefServer(models[0], policy=ref_pol, clock=RefClock(),
                    queue_capacity=2, backpressure="shed_oldest",
                    on_rejection=seen_ref.append)
    port = StreamServer(models[1], policy=port_pol, clock=VirtualClock(),
                        queue_capacity=2, backpressure="shed_oldest",
                        on_rejection=seen_port.append)
    for srv in (ref, port):
        for s in _streams(np.random.default_rng(3), [3, 3, 3]):
            srv.submit(s)
        srv.submit(np.zeros((0, N_IN), np.float32))
    assert [(r.reason, r.rid) for r in seen_port] == [("shed", 0),
                                                       ("empty", None)]
    assert [(r.rid, r.reason, r.detail, r.at) for r in seen_port] == \
        [(r.rid, r.reason, r.detail, r.at) for r in seen_ref]
    assert list(port.rejections) == seen_port


def test_zero_sigma_noise_normalized_to_off(rng, models):
    from repro_torch.core.noise import AnalogNoise
    server = StreamServer(models[1], policy=_policy(), clock=VirtualClock(),
                          noise=AnalogNoise(weight_sigma=0.0,
                                            leak_mismatch=0.1),
                          noise_probe_every=1)
    assert server.noise is None
    assert server.packed is server._clean_packed
    for s in _streams(rng, [3, 4]):
        server.submit(s)
    server.flush()
    snap = server.metrics.snapshot()
    assert snap["completed"] == 2
    assert snap["noise_probes"] == 0 and snap["noise_agreement"] == 1.0


# -------------------------------------------------------- shape bound

def test_async_trace_bound_and_hot_replay(rng, models):
    """A mixed async trace costs at most n_buckets new engine shapes;
    replaying it costs none."""
    policy = ((3,), (4, 8))
    streams = _streams(rng, [1, 2, 3, 5, 7, 8, 4, 6, 8, 2])
    trace = [(0.02 * i, s) for i, s in enumerate(streams)]
    port = models[1]
    svc = lambda b, t: 0.01  # noqa: E731  (wall EWMAs would differ)
    fresh = StreamServer(port, policy=policies(*policy)[1],
                         clock=VirtualClock(), default_slack=0.07,
                         service_model=svc)
    n0 = trace_count()
    serve_trace(fresh, trace)
    assert trace_count() - n0 <= 2
    n1 = trace_count()
    twin = Twin(*models, policy=policy, default_slack=0.07,
                service_model=svc)
    twin.serve_trace(trace)
    twin.check()
    assert trace_count() == n1, "hot async replay met new shapes"


# ----------------------------------------------------- wall clock / donation

def test_wallclock_live_smoke(rng, models):
    """A live trace on the real clock: results equal the closed-list runs
    of both packages; the latency metrics are wall-clock and not
    compared."""
    server = StreamServer(models[1], policy=_policy())
    assert isinstance(server.clock, WallClock)
    t0 = server.now()
    streams = _streams(rng, [3, 5, 7])
    rids = [server.submit(s, slack=30.0) for s in streams]
    time.sleep(0.005)
    assert server.now() > t0
    done = dict(server.poll())
    done.update(server.flush())
    assert set(done) == set(rids)
    ref = ref_run_bucketed(models[0], streams, policy=policies(*GRID)[0],
                           with_stats=False)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(done[rid].out_spikes,
                                      np.asarray(ref[i].out_spikes))
    snap = server.metrics.snapshot()
    assert snap["completed"] == 3 and snap["deadline_misses"] == 0
    assert all(lat >= 0.005 for lat in server.metrics.latency_s)


def test_donate_default_device_aware(models):
    """``donate=None`` resolves off for a CPU model and on for a CUDA one;
    an explicit value wins."""
    server = StreamServer(models[1], policy=_policy(), clock=VirtualClock())
    assert server.donate is False
    assert StreamServer(models[1], policy=_policy(), clock=VirtualClock(),
                        donate=True).donate is True
    assert should_donate(None, "cuda") is True
    assert should_donate(None, "cpu") is False
    assert should_donate(False, "cuda") is False


def test_donate_plumbs_through_dispatch(rng, models, monkeypatch):
    seen = []
    real = serving_mod.br.run_batched

    def spy(model, padded, **kw):
        seen.append(kw["donate"])
        return real(model, padded, **kw)

    monkeypatch.setattr(serving_mod.br, "run_batched", spy)
    server = StreamServer(models[1], policy=_policy(), clock=VirtualClock(),
                          donate=True)
    for s in _streams(rng, [3, 5, 6]):
        server.submit(s)
    server.flush()
    assert seen and all(d is True for d in seen)


def test_hot_dispatches_reuse_one_input_buffer(rng):
    """With donate on, back-to-back dispatches of one bucket refill the
    same input buffer: one buffer, one storage, however many dispatches —
    and the results are those of a server that allocates per call."""
    from repro_torch.launch.serve_snn import build_demo_model
    packed = build_demo_model("mlp", smoke=True).pack(device="cpu")
    plain = build_demo_model("mlp", smoke=True).pack(device="cpu")
    policy = BucketPolicy(batch_sizes=(2,), time_steps=(8,))
    server = StreamServer(packed, policy=policy, clock=VirtualClock(),
                          donate=True)
    other = StreamServer(plain, policy=policy, clock=VirtualClock(),
                         donate=False)
    ptrs = set()
    for _ in range(5):
        streams = _streams(rng, [5, 6])
        for s in streams:
            server.submit(s)
            other.submit(s)
        got, want = server.collect(), other.collect()
        assert len(got) == 2
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a.out_spikes, b.out_spikes)
        ptrs.add(packed.input_buffers[(2, 8)].data_ptr())
    assert list(packed.input_buffers) == [(2, 8)] and len(ptrs) == 1
    assert plain.input_buffers == {}


def test_mesh_recovery_rerounds_every_tenant_and_clears_estimates(rng,
                                                                  models):
    """A device lost at a dispatch on a spoofed 3-way mesh: the mesh
    shrinks to 2, every tenant's batch buckets are re-rounded to multiples
    of 2 (time buckets kept), the estimates measured on 3 devices are
    dropped, a ``device_loss`` anomaly is recorded, the dispatch is retried
    on the new bucket, and every request equals the single-device engine's
    run of it."""
    from repro_torch.engine import (FlightRecorder, ModelRegistry,
                                    make_chaos_hook, run_batched,
                                    snn_serve_mesh)
    packed = models[1]
    registry = ModelRegistry(device="cpu")
    registry.register("a", packed, policy=BucketPolicy(batch_sizes=(1, 3),
                                                      time_steps=(8,)))
    registry.register("b", packed, policy=BucketPolicy(batch_sizes=(3, 6),
                                                      time_steps=(8, 16)))
    tracer = FlightRecorder()
    server = StreamServer(registry, clock=VirtualClock(),
                          mesh=snn_serve_mesh(device="cpu", spoof=3),
                          chaos_hook=make_chaos_hook([(2, 1)]),
                          service_model=lambda b, t: 1e-3, tracer=tracer)
    assert server.mesh.size == 3
    streams = _streams(rng, (5, 8, 3, 7, 6, 4, 2, 8, 5))
    rids = []
    for i, s in enumerate(streams):
        rids.append(server.submit(s, model="ab"[(i // 3) % 2]))
    done = dict(server.flush())
    assert server.mesh.size == 2
    assert server._policy_for("a").batch_sizes == (2, 4)
    assert server._policy_for("b").batch_sizes == (4, 6)
    assert server._policy_for("b").time_steps == (8, 16)
    # dispatches: a's full bucket twice, then the flush of b's 3 requests,
    # where the loss fires; only that retried dispatch's estimate is left
    assert set(server._ewma) == {("b", 4, 8)}
    snap = server.metrics.snapshot()
    assert snap["device_losses"] == 1 and snap["completed"] == len(streams)
    assert tracer.anomaly_counts == {"device_loss": 1}
    event = next(e for e in tracer.events if e["kind"] == "device_loss")
    assert (event["n_lost"], event["mesh_from"], event["mesh_to"]) == \
        (1, 3, 2)
    assert [t["b_pad"] for t in server.telemetry] == [3, 3, 4]
    for rid, s in zip(rids, streams):
        np.testing.assert_array_equal(
            done[rid].out_spikes,
            run_batched(packed, s[None], with_stats=False).out_spikes[0])
