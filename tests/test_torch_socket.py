"""The port's live-socket front end (repro_torch/launch/socket_serve.py)
over real localhost connections, on models packed for the CPU.

Twins of the reference's socket tests (tests/test_chaos.py: round trip,
malformed requests, half-close, shed outbox; tests/test_multitenant.py:
tenant routing with an ADMIN hot-swap, corrupt-frame isolation;
tests/test_tracing.py: ADMIN metrics and trace).  Every request gets
exactly one answer, and every served result is held bit for bit against
the numpy oracle ``repro.core.accelerator.run`` or the reference's packed
route (``run_batched(model.pack(packed_ops=True))``) on the same layers.
Two more tests put each package's client against the other's server, two
run the launcher's ``--smoke`` script (on one device, and on a spoofed
2-way mesh), one shows that a fault which ends the serve loop reaches the
caller at once, and one that a device loss on a mesh does not: the server
shrinks its mesh and answers every request.

Every client times out within 30 s and every server thread is joined, so
a fault fails fast."""

import contextlib
import io
import socket
import time

import numpy as np
import pytest

from _torch_helpers import demo_models, map_both, pruned_mlp
from repro.core.accelerator import run as oracle_run
from repro.engine import run_batched as ref_run_batched

from repro_torch.engine import (METRIC_KEYS, BucketPolicy, DeviceLossError,
                                ModelRegistry, make_chaos_hook,
                                snn_serve_mesh)
from repro_torch.launch.socket_serve import (SpikeClient, SpikeSocketServer,
                                             main, serving_thread)

TIMEOUT = 30


def _models(seed, sizes=(14, 12, 6), threshold=0.5):
    """(reference mapped model, port model packed for the CPU) of the same
    seeded pruned MLP."""
    ref, port = map_both(pruned_mlp(np.random.default_rng(seed), sizes),
                         4, 8, beta=0.8, threshold=threshold)
    return ref, port.pack(device="cpu")


def _oracle(ref_mapped, stream):
    return oracle_run(ref_mapped, stream).out_spikes


def _streams(rng, n_in, lengths, p=0.3):
    return [(rng.random((t, n_in)) < p).astype(np.float32) for t in lengths]


def _reference_packed_route(ref_model, streams):
    """Each stream's output spikes on the reference's packed route, all in
    one padded batch (one interpret-mode trace)."""
    t_max = max(s.shape[0] for s in streams)
    x = np.zeros((len(streams), t_max, streams[0].shape[1]), np.float32)
    for i, s in enumerate(streams):
        x[i, :s.shape[0]] = s
    out = np.asarray(ref_run_batched(ref_model, x,
                                     with_stats=False).out_spikes)
    return [out[i, :s.shape[0]] for i, s in enumerate(streams)]


# ------------------------------------------------------- twins: test_chaos

def test_socket_server_round_trip_is_bit_exact(rng):
    """A real localhost connection through the ingest protocol: every
    request answered, results bit-exact against the reference's packed
    route and the oracle, overlong requests rejected with a reason."""
    ref, packed = _models(0)
    streams = _streams(rng, packed.n_in, (3, 5, 9, 4, 7, 9))
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(2, 4), time_steps=(10,)),
        port=0, overlong="reject")
    host, port = srv.address
    with serving_thread(srv, max_requests=len(streams)):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        for s in streams:
            cli.send(s)
        overlong = cli.send(_streams(rng, packed.n_in, (40,))[0])
        cli.recv_all()
        cli.close()
    assert len(cli.results) == len(streams)
    assert set(cli.rejections) == {overlong}
    assert "overlong" in cli.rejections[overlong]
    want = _reference_packed_route(ref.pack(packed_ops=True), streams)
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(cli.results[i], want[i],
                                      err_msg=f"socket result {i}")
        np.testing.assert_array_equal(cli.results[i], _oracle(ref, s))
    assert srv.server.metrics.snapshot()["completed"] == len(streams)


def test_socket_malformed_request_rejected_server_survives(rng):
    """A protocol-valid REQUEST whose raster width disagrees with the
    model's n_in, or whose claimed T passes the socket cap, answers with a
    REJECT frame and leaves the loop serving: a good request after them
    still serves bit-exact."""
    ref, packed = _models(1)
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(1,), time_steps=(10,)),
        port=0, max_request_steps=64)
    host, port = srv.address
    good = _streams(rng, packed.n_in, (5,))[0]
    with serving_thread(srv, max_requests=1):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        bad_width = cli.send(_streams(rng, packed.n_in + 3, (5,))[0])
        too_long = cli.send(_streams(rng, packed.n_in, (65,))[0])
        ok = cli.send(good)
        cli.recv_all()
        cli.close()
    assert "bad_shape" in cli.rejections[bad_width]
    assert "overlong" in cli.rejections[too_long]
    assert set(cli.results) == {ok}
    np.testing.assert_array_equal(cli.results[ok], _oracle(ref, good))


def test_socket_halfclose_drains_via_idle_flush(rng):
    """A client that sends one best-effort request and half-closes its
    write side (EOF at the server) still gets its result: EOF unregisters
    the read side, so the half-closed socket cannot busy-spin select() and
    starve the idle flush the pending request needs."""
    ref, packed = _models(2)
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(4,), time_steps=(10,)),
        port=0)
    host, port = srv.address
    s = _streams(rng, packed.n_in, (6,))[0]
    with serving_thread(srv, max_requests=1, idle_flush_s=0.05):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        rid = cli.send(s)
        cli.sock.shutdown(socket.SHUT_WR)   # EOF at the server
        cli.recv_all()
        cli.close()
    np.testing.assert_array_equal(cli.results[rid], _oracle(ref, s))


def test_socket_shed_rejections_delivered_from_outbox(rng):
    """A queued request displaced by shed_oldest backpressure after
    admission is answered with a REJECT frame from the rejection outbox,
    and the survivors still serve bit-exact."""
    ref, packed = _models(3)
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(4,), time_steps=(10,)),
        port=0, queue_capacity=2, backpressure="shed_oldest")
    host, port = srv.address
    streams = _streams(rng, packed.n_in, (4, 4, 4))
    with serving_thread(srv, max_requests=2, idle_flush_s=0.2):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        rids = [cli.send(s) for s in streams]
        cli.recv_all()
        cli.close()
    assert "shed" in cli.rejections[rids[0]]
    assert set(cli.results) == {rids[1], rids[2]}
    for r in rids[1:]:
        np.testing.assert_array_equal(cli.results[r],
                                      _oracle(ref, streams[r]))


# -------------------------------------------------- twins: test_multitenant

@pytest.fixture(scope="module")
def tenants():
    """alpha, alpha2 (same shapes, other weights: the hot-swap payload) and
    beta, as (reference mapped, port packed) pairs."""
    return {"alpha": _models(7, threshold=0.7),
            "alpha2": _models(8, threshold=0.7),
            "beta": _models(9, sizes=(11, 10, 5), threshold=0.7)}


def _registry(tenants):
    reg = ModelRegistry(device="cpu")
    for name in ("alpha", "beta"):
        reg.register(name, tenants[name][1],
                     policy=BucketPolicy(batch_sizes=(1, 2, 4),
                                         time_steps=(4, 8)))
    return reg


def test_socket_routes_tenants_and_hot_swaps_via_admin(rng, tenants):
    """End to end over a real connection: v2 frames route by name, a v1
    frame routes to the default tenant, ADMIN list enumerates the fabric,
    ADMIN swap installs new weights through the model factory, and every
    result is bit-exact against the weights live at admission."""
    srv = SpikeSocketServer(_registry(tenants), port=0,
                            model_factory=lambda spec: tenants["alpha2"][1])
    host, port = srv.address
    sa = _streams(rng, 14, [3, 7, 5], p=0.35)
    sb = _streams(rng, 11, [4, 6], p=0.35)
    post = _streams(rng, 14, [5, 8], p=0.35)
    n_results = len(sa) + len(sb) + len(post)
    with serving_thread(srv, max_requests=n_results, idle_flush_s=0.05):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        pre_ids = [cli.send(s, model="alpha") for s in sa[:-1]]
        pre_ids.append(cli.send(sa[-1], version=1))   # v1 -> default (alpha)
        b_ids = [cli.send(s, model="beta") for s in sb]
        lst = cli.admin({"op": "list"})
        unknown = cli.send(_streams(rng, 14, [4])[0], model="gamma")
        adm = cli.admin({"op": "swap", "model": "alpha"})
        post_ids = [cli.send(s, model="alpha") for s in post]
        cli.recv_all()
        cli.close()
    reply = cli.admin_replies[lst]
    assert reply["ok"] and reply["default"] == "alpha"
    assert reply["models"] == {"alpha": 1, "beta": 1}
    assert "unknown_model" in cli.rejections[unknown]
    assert "gamma" in cli.rejections[unknown]
    swap_reply = cli.admin_replies[adm]
    assert swap_reply == {"ok": True, "model": "alpha", "generation": 2}
    for ids, streams, name in ((pre_ids, sa, "alpha"), (b_ids, sb, "beta"),
                               (post_ids, post, "alpha2")):
        for req_id, s in zip(ids, streams):
            np.testing.assert_array_equal(
                cli.results[req_id], _oracle(tenants[name][0], s),
                err_msg=f"request {req_id} not served on {name}'s weights")
    snap = srv.server.metrics.snapshot()
    assert snap["hot_swaps"] == 1 and snap["completed"] == n_results
    assert srv.tracer.anomaly_counts.get("hot_swap_pin") == 1


def test_socket_corrupt_frame_drops_only_that_connection(rng, tenants):
    """A corrupt frame poisons one connection's decoder, and only that
    connection dies — its buffer is reset and dropped, while a healthy
    neighbour keeps serving bit-exact."""
    srv = SpikeSocketServer(_registry(tenants), port=0)
    host, port = srv.address
    good_streams = _streams(rng, 14, [5, 3], p=0.35)
    with serving_thread(srv, max_requests=len(good_streams),
                        idle_flush_s=0.05):
        bad = SpikeClient(host, port, timeout=TIMEOUT)
        good = SpikeClient(host, port, timeout=TIMEOUT)
        bad.sock.sendall(b"XX" + b"\x00" * 30)       # corrupt magic
        ids = [good.send(s, model="alpha") for s in good_streams]
        good.recv_all()
        # the offender is disconnected, not answered
        assert bad.sock.recv(1 << 10) == b"", \
            "server kept a connection whose stream cannot resync"
        bad.close()
        good.close()
    for req_id, s in zip(ids, good_streams):
        np.testing.assert_array_equal(good.results[req_id],
                                      _oracle(tenants["alpha"][0], s))


# ----------------------------------------------------- twin: test_tracing

def test_socket_admin_metrics_and_trace():
    """ADMIN `metrics` returns the schema-locked snapshot and `trace
    <rid>|last` returns span traces over a live socket; the served results
    equal the reference's packed route on the same demo model."""
    ref, packed = demo_models("mlp")
    streams = [(np.random.default_rng(seed).random((6, packed.n_in)) < 0.2)
               .astype(np.float32) for seed in range(4)]
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(2,), time_steps=(8,)))
    host, port = srv.address
    with serving_thread(srv, idle_flush_s=0.05):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        for s in streams:
            cli.send(s)
        cli.recv_all()                  # all results in -> traces completed
        assert len(cli.results) == 4
        met = cli.admin({"op": "metrics"})
        last = cli.admin({"op": "trace", "last": True})
        one = cli.admin({"op": "trace", "rid": 0})
        dump = cli.admin({"op": "trace"})
        bad = cli.admin({"op": "trace", "rid": 10 ** 9})
        nope = cli.admin({"op": "reboot"})
        cli.recv_all()
        cli.close()
    mrep = cli.admin_replies[met]
    # json sorts keys on the wire: same key *set*, values by name
    assert mrep["ok"] and set(mrep["metrics"]) == set(METRIC_KEYS)
    assert mrep["metrics"]["completed"] == 4
    trep = cli.admin_replies[last]
    assert trep["ok"] and trep["trace"]["completed"]
    kinds = [sp["kind"] for sp in trep["trace"]["spans"]]
    assert "dispatch" in kinds and kinds[0] == "admit"
    assert cli.admin_replies[one]["trace"]["rid"] == 0
    drep = cli.admin_replies[dump]
    assert drep["ok"] and drep["dump"]["n_completed"] == 4
    assert not cli.admin_replies[bad]["ok"]
    assert "no trace for rid" in cli.admin_replies[bad]["error"]
    assert cli.admin_replies[nope] == {
        "ok": False, "error": "ValueError: unknown admin op 'reboot'"}
    want = _reference_packed_route(ref, streams)
    for i in range(4):
        np.testing.assert_array_equal(cli.results[i], want[i])


# ------------------------------------------------------ across packages

def test_port_client_against_reference_server(rng):
    """The port's SpikeClient drives the reference's SpikeSocketServer (on
    its packed route): v1 and v2 requests, a bad shape and ADMIN metrics,
    every answer decoded by the port's protocol."""
    from repro.engine import BucketPolicy as RefPolicy
    from repro.launch import socket_serve as ref_socket

    ref, packed = _models(11)
    streams = _streams(rng, packed.n_in, (3, 6, 9, 5))
    srv = ref_socket.SpikeSocketServer(
        ref.pack(packed_ops=True),
        policy=RefPolicy(batch_sizes=(4,), time_steps=(10,)), port=0)
    host, port = srv.address
    with ref_socket.serving_thread(srv, max_requests=len(streams),
                                   idle_flush_s=0.05):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        # answered before the last result ends the loop (max_requests)
        bad = cli.send(_streams(rng, packed.n_in + 1, (4,))[0])
        met = cli.admin({"op": "metrics"})
        ids = [cli.send(s, version=1 if i == 0 else 2)
               for i, s in enumerate(streams)]
        cli.recv_all()
        cli.close()
    assert "bad_shape" in cli.rejections[bad]
    assert set(cli.admin_replies[met]["metrics"]) == set(METRIC_KEYS)
    for req_id, s in zip(ids, streams):
        np.testing.assert_array_equal(cli.results[req_id], _oracle(ref, s))


def test_reference_client_against_port_server(rng, tenants):
    """The reference's SpikeClient drives the port's server: tenant
    routing, a v1 frame, an ADMIN swap and list, all decoded by the
    reference's protocol, results bit-exact against the oracle."""
    from repro.launch import socket_serve as ref_socket

    srv = SpikeSocketServer(_registry(tenants), port=0,
                            model_factory=lambda spec: tenants["alpha2"][1])
    host, port = srv.address
    sa = _streams(rng, 14, [4, 8], p=0.35)
    sb = _streams(rng, 11, [3], p=0.35)
    post = _streams(rng, 14, [6], p=0.35)
    with serving_thread(srv, max_requests=4, idle_flush_s=0.05):
        cli = ref_socket.SpikeClient(host, port, timeout=TIMEOUT)
        a_ids = [cli.send(sa[0], version=1), cli.send(sa[1], model="alpha")]
        b_id = cli.send(sb[0], model="beta")
        adm = cli.admin({"op": "swap", "model": "alpha"})
        lst = cli.admin({"op": "list"})
        post_id = cli.send(post[0], model="alpha")
        cli.recv_all()
        cli.close()
    assert cli.admin_replies[adm]["generation"] == 2
    assert cli.admin_replies[lst]["models"] == {"alpha": 2, "beta": 1}
    for req_id, s in zip(a_ids, sa):
        np.testing.assert_array_equal(cli.results[req_id],
                                      _oracle(tenants["alpha"][0], s))
    np.testing.assert_array_equal(cli.results[b_id],
                                  _oracle(tenants["beta"][0], sb[0]))
    np.testing.assert_array_equal(cli.results[post_id],
                                  _oracle(tenants["alpha2"][0], post[0]))


# ------------------------------------------------------------ launcher

def test_launcher_smoke_on_the_cpu():
    """`python -m repro_torch.launch.socket_serve --models mlp,conv --smoke
    --device cpu` serves every tenant, a v1 frame, a hot-swap and the
    ADMIN observability verbs, and checks each itself."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--models", "mlp,conv", "--smoke", "--device", "cpu",
              "--port", "0"])
    lines = out.getvalue().splitlines()
    assert "on cpu, 2 tenant(s): mlp, conv" in lines[0]
    assert lines[-1].startswith(
        "socket-serve smoke: 18 served across 2 tenant(s) (conv=6, mlp=12), "
        "1 hot-swap")


def test_launcher_smoke_on_a_spoofed_mesh():
    """`... socket_serve --models mlp,conv --smoke --device cpu
    --spoof-devices 2`: the same smoke, every bucket split over a 2-way
    mesh of the CPU; more real devices than exist are refused."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--models", "mlp,conv", "--smoke", "--device", "cpu",
              "--port", "0", "--spoof-devices", "2"])
    lines = out.getvalue().splitlines()
    assert "on cpu, 2-way mesh, 2 tenant(s): mlp, conv" in lines[0]
    assert lines[-1].startswith(
        "socket-serve smoke: 18 served across 2 tenant(s) (conv=6, mlp=12), "
        "1 hot-swap")
    with pytest.raises(ValueError, match="2-way mesh"):
        main(["--smoke", "--device", "cpu", "--port", "0", "--data", "2"])


def test_device_loss_on_a_mesh_recovers_over_the_wire(rng):
    """A scripted device loss at the first dispatch of a server on a
    spoofed 2-way mesh: the mesh shrinks to 1, the connection stays open,
    and every request is answered bit-exact against the oracle."""
    ref, packed = _models(4)
    streams = _streams(rng, packed.n_in, (4, 5, 9, 3))
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(2,), time_steps=(10,)),
        port=0, mesh=snn_serve_mesh(device="cpu", spoof=2),
        chaos_hook=make_chaos_hook([(0, 1)]))
    host, port = srv.address
    with serving_thread(srv, max_requests=len(streams)):
        cli = SpikeClient(host, port, timeout=TIMEOUT)
        for s in streams:
            cli.send(s)
        cli.recv_all()
        cli.close()
    assert srv.server.mesh.size == 1
    snap = srv.server.metrics.snapshot()
    assert snap["device_losses"] == 1 and snap["completed"] == len(streams)
    assert srv.tracer.anomaly_counts.get("device_loss") == 1
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(cli.results[i], _oracle(ref, s))


def test_serve_thread_fault_reaches_the_caller(rng):
    """An exception that ends the serve loop (here a scripted device loss
    at the first dispatch, fatal on one device) closes the connection at
    once, so the blocked client does not wait out its timeout, and
    serving_thread raises it in the caller's thread."""
    _, packed = _models(4)
    srv = SpikeSocketServer(
        packed, policy=BucketPolicy(batch_sizes=(2,), time_steps=(10,)),
        port=0, chaos_hook=make_chaos_hook([(0, 1)]))
    host, port = srv.address
    t0 = time.monotonic()
    with pytest.raises(DeviceLossError):
        with serving_thread(srv, max_requests=2):
            cli = SpikeClient(host, port, timeout=TIMEOUT)
            for s in _streams(rng, packed.n_in, (4, 5)):
                cli.send(s)             # a full bucket: dispatches inline
            with pytest.raises(ConnectionError):
                cli.recv_all()
            cli.close()
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_launcher_on_cuda_raises_without_a_card():
    """`--device cuda`, the default, never falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would serve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--device", "cuda", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--models", "mlp,conv", "--smoke", "--port", "0"])
