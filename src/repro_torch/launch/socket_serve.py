"""Live-socket serving front end: real connections -> StreamServer.

Binds the always-on loop (:mod:`repro_torch.engine.stream_server`) to a
TCP socket speaking the length-prefixed :mod:`repro_torch.engine.ingest`
protocol, so real clients (a DVS gateway, a soak harness) drive admission,
deadlines, backpressure and hot-swaps over a live connection, with every
engine call on the card:

  PYTHONPATH=src python -m repro_torch.launch.socket_serve --model mlp \
      --port 7473 [--device cuda|cpu] [--data 2] [--spoof-devices 2] \
      [--noise-sigma 0.05] [--slo-target 0.1] [--smoke]
  PYTHONPATH=src python -m repro_torch.launch.socket_serve \
      --models mlp,conv --port 7473 [--device cpu] [--smoke]
      # multi-tenant fabric, one tenant per name

``--device cuda`` (the default) serves through the hand-written kernels
and raises when there is no card; ``--device cpu`` serves through their
plain PyTorch versions.  ``--data N`` serves over an N-way mesh of cards
and ``--spoof-devices N`` over N logical shards of the one ``--device``
(:func:`repro_torch.engine.sharded_run.snn_serve_mesh`), with the bucket
batches rounded to the mesh's size; a device loss then shrinks the mesh
and serving goes on.  The frames are byte-identical to the JAX package's,
so clients and servers of either package talk to each other.

Design: a single-threaded ``selectors`` event loop.  Engine dispatches run
inline (the loop drains sockets between engine calls — exactly the
single-threaded-server model ``serve_trace`` simulates, so soak numbers and
the VirtualClock replays describe the same machine).  The select timeout
tracks ``StreamServer.next_deadline()``, so deadline-forced partial
dispatches fire on time even when no bytes arrive.  Every request gets an
answer: results as bit-exact spike rasters, rejections (admission,
backpressure, shed, unknown model, bad shape) as reasoned REJECT frames.

Multi-tenant serving: v2 REQUEST frames carry a model name and route to
that tenant of the server's
:class:`~repro_torch.engine.registry.ModelRegistry`; v1 frames (older edge
sensors) route to the default model.  ADMIN frames are the control plane —
``{"op": "swap", "model": ..., ...}`` hot-swaps a tenant live through the
configured ``model_factory`` (in-flight requests drain on the old weights,
zero drops), ``{"op": "list"}`` enumerates tenants and their generations,
``{"op": "metrics"}`` returns the schema-locked
``ServerMetrics.snapshot()``, and ``{"op": "trace"}`` exports per-request
span traces / the flight-recorder dump (the server runs a
:class:`~repro_torch.engine.tracing.FlightRecorder` by default).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import math
import selectors
import socket
import threading
import time

import numpy as np

from repro_torch.engine import ingest
from repro_torch.engine.registry import ModelRegistry, UnknownModelError
from repro_torch.engine.serving import BucketPolicy
from repro_torch.engine.stream_server import SLOPolicy, StreamServer
from repro_torch.engine.tracing import FlightRecorder

_log = logging.getLogger(__name__)

# select timeout ceiling: how stale next_deadline() may get while idle
_TICK_S = 0.05


class _Conn:
    """Per-connection state: incremental decoder + in-flight accounting."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.decoder = ingest.FrameDecoder()
        self.inflight = 0
        self.draining = False       # client sent EOF; close when drained


class SpikeSocketServer:
    """A :class:`StreamServer` behind a TCP listener.

    ``serve(...)`` runs the event loop in the calling thread;
    :func:`serving_thread` wraps it for in-process harnesses.  The
    ``StreamServer`` knobs (noise, SLO policy, chaos hook, backpressure)
    pass through ``server_kwargs``.

    ``model`` is a single packed/mapped model (with ``policy``) or a
    :class:`~repro_torch.engine.registry.ModelRegistry` (multi-tenant;
    leave ``policy`` unset).  ``model_factory(spec: dict) -> PackedModel``
    turns an ADMIN swap request's JSON body into new weights; without one,
    swap requests are refused (the data plane is unaffected).

    A live socket server always runs a flight recorder (``tracer``; pass
    your own :class:`~repro_torch.engine.tracing.FlightRecorder` to size
    the rings) — the ADMIN ``metrics`` / ``trace`` verbs are the wire
    export of ``ServerMetrics.snapshot()`` and the recorder.
    """

    def __init__(self, model, *, policy: BucketPolicy | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_request_steps: int = 4096, model_factory=None,
                 tracer: FlightRecorder | None = None,
                 **server_kwargs):
        self.tracer = tracer if tracer is not None else FlightRecorder()
        self.server = StreamServer(model, policy=policy,
                                   on_rejection=self._on_rejection,
                                   tracer=self.tracer,
                                   **server_kwargs)
        self.model_factory = model_factory
        # untrusted-input bound: a protocol-valid REQUEST header may claim
        # any u32 T; cap it before unpacking (T * n_in float32 blows up
        # ~32x over the wire size) and before it reaches admission
        self.max_request_steps = max_request_steps
        self._listener = socket.create_server((host, port))
        self._listener.setblocking(False)
        self.address = self._listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._conns: dict[socket.socket, _Conn] = {}
        self._owner: dict[int, tuple[_Conn, int]] = {}  # rid -> (conn, req_id)
        # rejections arrive via the server's on_rejection callback, an
        # unbounded outbox: post-admission sheds are answered from here by
        # _drain_new_rejections, never inferred from the bounded metrics
        # deque (which overflows under sustained shed-mode load)
        self._rej_outbox: list = []
        self._last_inline_rej = None
        self._stop = threading.Event()
        self._closed = False
        self.served = 0

    # ------------------------------------------------------------- control

    def stop(self) -> None:
        """Ask the loop to exit after its current iteration (thread-safe)."""
        self._stop.set()

    # ----------------------------------------------------------- plumbing

    def _send(self, conn: _Conn, data: bytes) -> None:
        try:
            conn.sock.sendall(data)
        except OSError:
            self._drop(conn)

    def _drop(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        with contextlib.suppress(KeyError):
            self._sel.unregister(conn.sock)
        del self._conns[conn.sock]
        conn.sock.close()
        # orphan its in-flight requests: results with no owner are dropped
        self._owner = {rid: (c, q) for rid, (c, q) in self._owner.items()
                       if c is not conn}

    def _on_rejection(self, rej) -> None:
        """StreamServer's rejection callback (fires inside ``submit``)."""
        if rej.rid is None:
            self._last_inline_rej = rej  # answered by _on_request's caller
        else:
            self._rej_outbox.append(rej)

    def _drain_new_rejections(self) -> None:
        """Answer every post-admission rejection (queued requests shed by
        backpressure) accumulated in the outbox since the last drain."""
        if not self._rej_outbox:
            return
        outbox, self._rej_outbox = self._rej_outbox, []
        for rej in outbox:
            owner = self._owner.pop(rej.rid, None)
            if owner is not None:
                conn, req_id = owner
                conn.inflight -= 1
                self._send(conn, ingest.encode_rejection(
                    req_id, f"{rej.reason}: {rej.detail}"))

    def _deliver(self, done) -> None:
        for rid, res in done:
            owner = self._owner.pop(rid, None)
            if owner is None:
                continue            # connection vanished mid-service
            conn, req_id = owner
            conn.inflight -= 1
            self.served += 1
            self._send(conn, ingest.encode_result(req_id, res.out_spikes))

    def _on_request(self, conn: _Conn, frame: ingest.Frame) -> None:
        # resolve the tenant and validate the claimed shape BEFORE
        # unpacking or submitting: a well-framed request with an unknown
        # model, the wrong raster width, or an absurd T must answer with a
        # REJECT, not raise out of the event loop and kill serving for
        # every other connected client.  v1 frames carry no model name and
        # route to the registry default.
        req_id, t, n_in, slack, model = ingest.peek_request(
            frame.payload, frame.version)
        try:
            entry = self.server.registry.get(model)
        except UnknownModelError as e:
            self._send(conn, ingest.encode_rejection(
                req_id, f"unknown_model: {e}"))
            return
        want = entry.packed.n_in
        if n_in != want:
            self._send(conn, ingest.encode_rejection(
                req_id, f"bad_shape: raster width {n_in} != model "
                        f"{entry.name!r} n_in {want}"))
            return
        if t > self.max_request_steps:
            self._send(conn, ingest.encode_rejection(
                req_id, f"overlong: {t} steps > socket cap "
                        f"{self.max_request_steps}"))
            return
        _, stream, slack, model = ingest.decode_request(
            frame.payload, frame.version)
        rid = self.server.submit(
            stream, model=model, slack=None if math.isinf(slack) else slack)
        if rid is None:
            rej = self._last_inline_rej
            self._send(conn, ingest.encode_rejection(
                req_id, f"{rej.reason}: {rej.detail}"))
            return
        self._owner[rid] = (conn, req_id)
        conn.inflight += 1

    def _on_admin(self, conn: _Conn, frame: ingest.Frame) -> None:
        """Control plane: hot-swap a tenant / list tenants / export metrics
        and traces.  Every admin request gets an ADMIN reply echoing its
        req_id; failures answer ``{"ok": false, "error": ...}`` instead of
        touching the data plane."""
        req_id, body = ingest.decode_admin(frame.payload)
        op = body.get("op")
        try:
            if op == "metrics":
                # the full schema-locked snapshot (METRIC_KEYS, with the
                # PER_MODEL_KEYS sub-table) — note json sorts keys on the
                # wire, so consumers key by name, not position
                reply = {"ok": True,
                         "metrics": self.server.metrics.snapshot()}
            elif op == "trace":
                tr = self.server.tracer
                if tr is None:
                    raise RuntimeError("tracing is disabled on this server")
                if body.get("rid") is not None:
                    t = tr.trace(int(body["rid"]))
                    if t is None:
                        raise KeyError(
                            f"no trace for rid {body['rid']} (completed "
                            f"ring keeps the last {tr.completed.maxlen})")
                    reply = {"ok": True, "trace": t.to_dict()}
                elif body.get("last"):
                    t = tr.last()
                    if t is None:
                        raise KeyError("no completed traces yet")
                    reply = {"ok": True, "trace": t.to_dict()}
                else:
                    reply = {"ok": True, "dump": tr.dump()}
            elif op == "list":
                reply = {"ok": True,
                         "default": self.server.registry.default,
                         "models": {n: self.server.registry.get(n).generation
                                    for n in self.server.registry.names()}}
            elif op == "swap":
                if self.model_factory is None:
                    raise RuntimeError("no model_factory configured; "
                                       "hot-swap is disabled on this server")
                name = body.get("model") or self.server.registry.default
                packed = self.model_factory(dict(body))
                entry = self.server.swap(name, packed)
                # the swap drained the tenant's in-flight requests on the
                # old weights — answer their owners before acking the swap
                self._deliver(self.server.collect())
                reply = {"ok": True, "model": name,
                         "generation": entry.generation}
                _log.info("socket_serve: hot-swapped %r -> generation %d",
                          name, entry.generation)
            else:
                raise ValueError(f"unknown admin op {op!r}")
        except Exception as e:  # control plane: report, never crash serving
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        self._send(conn, ingest.encode_admin(req_id, reply))

    def _on_readable(self, sock: socket.socket) -> None:
        if sock is self._listener:
            client, addr = self._listener.accept()
            client.setblocking(False)
            conn = _Conn(client)
            self._conns[client] = conn
            self._sel.register(client, selectors.EVENT_READ, conn)
            _log.info("socket_serve: connection from %s", addr)
            return
        conn = self._conns[sock]
        try:
            chunk = sock.recv(1 << 16)
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            # EOF: finish its in-flight, then close.  Unregister the read
            # side now — a half-closed socket is permanently readable, so
            # leaving it in the selector busy-spins select() and keeps
            # refreshing last_activity, starving the idle-flush path the
            # connection needs to ever drain.  The write side stays open
            # for the pending results.
            conn.draining = True
            with contextlib.suppress(KeyError):
                self._sel.unregister(sock)
            return
        try:
            for frame in conn.decoder.feed(chunk):
                if frame.kind == ingest.KIND_ADMIN:
                    self._on_admin(conn, frame)
                elif frame.kind == ingest.KIND_REQUEST:
                    self._on_request(conn, frame)
                else:
                    raise ingest.ProtocolError(
                        f"client sent frame kind {frame.kind}, "
                        f"expected REQUEST or ADMIN")
                # a full-bucket submit may have dispatched inline
                self._deliver(self.server.collect())
                self._drain_new_rejections()
        except ingest.ProtocolError as e:
            # the stream is corrupt beyond resync: discard this
            # connection's buffered bytes (FrameDecoder.reset) so nothing
            # re-parses them, then drop only this client — other
            # connections keep their own decoders and never notice
            dropped = conn.decoder.reset()
            _log.warning("socket_serve: protocol error, dropping client "
                         "(%d buffered bytes discarded): %s", dropped, e)
            self._drop(conn)

    # ---------------------------------------------------------------- loop

    def _tick(self) -> None:
        """One scheduler beat: fire due deadline dispatches, deliver."""
        self._deliver(self.server.poll())
        self._drain_new_rejections()
        for conn in [c for c in self._conns.values()
                     if c.draining and c.inflight == 0]:
            self._drop(conn)

    def serve(self, *, max_requests: int | None = None,
              idle_flush_s: float = 0.25) -> None:
        """Run the event loop until :meth:`stop` (or ``max_requests``
        results have been served).  ``idle_flush_s``: with pending
        best-effort requests, no deadline due, and no bytes arriving for
        this long, flush — a lone trailing request never hangs the
        socket."""
        last_activity = time.monotonic()
        while not self._stop.is_set():
            nd = self.server.next_deadline()
            timeout = (_TICK_S if nd is None
                       else min(max(nd - self.server.now(), 0.0), _TICK_S))
            events = self._sel.select(timeout)
            if events:
                last_activity = time.monotonic()
            for key, _ in events:
                self._on_readable(key.fileobj)
            self._tick()
            if (self.server.queue_depth > 0 and not events
                    and self.server.next_deadline() is None
                    and time.monotonic() - last_activity > idle_flush_s):
                self._deliver(self.server.flush())
                self._drain_new_rejections()
            if max_requests is not None and self.served >= max_requests:
                break
        self._deliver(self.server.flush())
        self._drain_new_rejections()

    def close(self) -> None:
        """Stop the loop and close every connection and the listener
        (idempotent)."""
        self.stop()
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns.values()):
            self._drop(conn)
        with contextlib.suppress(KeyError):
            self._sel.unregister(self._listener)
        self._listener.close()
        self._sel.close()


@contextlib.contextmanager
def serving_thread(server: SpikeSocketServer, **serve_kwargs):
    """Run ``server.serve()`` on a daemon thread for in-process harnesses;
    joins and closes on exit.

    An exception that ends ``serve()`` (a device fault in an engine call,
    say) closes the server at once, so a client blocked on a reply sees
    the connection close instead of waiting out its timeout, and is raised
    again here, in the caller's thread, on exit: a harness cannot pass
    because its client happened to finish while the server died."""
    failure: list[BaseException] = []

    def run():
        try:
            server.serve(**serve_kwargs)
        except BaseException as e:  # handed to the caller's thread below
            failure.append(e)
            server.close()

    t = threading.Thread(target=run, daemon=True, name="spike-socket-serve")
    t.start()
    try:
        yield server
    finally:
        server.stop()
        t.join(timeout=30)
        stuck = t.is_alive()
        if not stuck:
            server.close()
        if failure:
            raise failure[0]
        if stuck:
            raise RuntimeError("the serve thread did not stop within 30 s")


# ------------------------------------------------------------------ client

class SpikeClient:
    """A minimal blocking client for the ingest protocol — what a soak
    harness runs many of.  ``send`` streams a request; ``recv_all`` blocks
    until every outstanding request is answered (result or rejection)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.decoder = ingest.FrameDecoder()
        self._next_id = 0
        self.results: dict[int, np.ndarray] = {}
        self.rejections: dict[int, str] = {}
        self.admin_replies: dict[int, dict] = {}

    def send(self, stream, slack: float = math.inf, *,
             model: str | None = None,
             version: int = ingest.VERSION) -> int:
        """Stream one request.  ``model`` routes to that tenant (v2);
        ``version=1`` emits a legacy frame (no model id — exercises the
        default-model compatibility path)."""
        req_id = self._next_id
        self._next_id += 1
        self.sock.sendall(ingest.encode_request(req_id, stream, slack,
                                                model=model,
                                                version=version))
        return req_id

    def admin(self, body: dict) -> int:
        """Send a control-plane request (e.g. ``{"op": "swap", "model":
        ..., ...}``); the reply lands in :attr:`admin_replies`."""
        req_id = self._next_id
        self._next_id += 1
        self.sock.sendall(ingest.encode_admin(req_id, body))
        return req_id

    def _pump(self) -> None:
        chunk = self.sock.recv(1 << 16)
        if not chunk:
            raise ConnectionError("server closed the connection")
        for frame in self.decoder.feed(chunk):
            if frame.kind == ingest.KIND_RESULT:
                req_id, out = ingest.decode_result(frame.payload)
                self.results[req_id] = out
            elif frame.kind == ingest.KIND_REJECT:
                req_id, reason = ingest.decode_rejection(frame.payload)
                self.rejections[req_id] = reason
            elif frame.kind == ingest.KIND_ADMIN:
                req_id, body = ingest.decode_admin(frame.payload)
                self.admin_replies[req_id] = body
            else:
                raise ingest.ProtocolError(
                    f"server sent frame kind {frame.kind}")

    def recv_all(self) -> None:
        """Block until every sent request has a result, a rejection, or an
        admin reply."""
        while (len(self.results) + len(self.rejections)
               + len(self.admin_replies)) < self._next_id:
            self._pump()

    def close(self) -> None:
        self.sock.close()


# --------------------------------------------------------------------- CLI

def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"socket-serve smoke: {what}")


def main(argv=None):
    from repro_torch.core.noise import AnalogNoise
    from repro_torch.engine.sharded_run import snn_serve_mesh
    from repro_torch.engine.stream_server import METRIC_KEYS
    from repro_torch.launch.serve_snn import build_demo_model, synth_requests

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "conv"])
    ap.add_argument("--models", default=None,
                    help="comma-separated demo model kinds (e.g. mlp,conv): "
                         "serve them as a multi-tenant fabric, one tenant "
                         "per name, with ADMIN hot-swap enabled; overrides "
                         "--model")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7473)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card "
                         "(raises with no card); cpu: their plain versions")
    ap.add_argument("--data", type=int, default=None,
                    help="serve over a mesh of this many devices (the "
                         "first N cards, or of the --spoof-devices shards)")
    ap.add_argument("--spoof-devices", type=int, default=None,
                    help="make the mesh N logical shards over the one "
                         "--device")
    ap.add_argument("--queue-capacity", type=int, default=256)
    ap.add_argument("--backpressure", default="reject",
                    choices=["reject", "shed_oldest"])
    ap.add_argument("--default-slack", type=float, default=math.inf,
                    help="deadline slack for requests that send inf")
    ap.add_argument("--noise-sigma", type=float, default=0.0,
                    help="serving-time C2C gain error (core/noise.py); "
                         "shadow probes feed the noise_agreement metric")
    ap.add_argument("--slo-target", type=float, default=None,
                    help="enable SLO shed-vs-extend switching at this "
                         "windowed deadline-miss rate")
    ap.add_argument("--smoke", action="store_true",
                    help="serve a built-in burst of local requests through "
                         "the socket and exit (liveness check)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    noise = (AnalogNoise(weight_sigma=args.noise_sigma)
             if args.noise_sigma > 0 else None)
    slo = (SLOPolicy(target_miss_rate=args.slo_target)
           if args.slo_target is not None else None)
    mesh = None
    if args.data is not None or args.spoof_devices is not None:
        mesh = snn_serve_mesh(args.data, device=args.device,
                              spoof=args.spoof_devices)
    n_shards = mesh.size if mesh is not None else 1

    def model_factory(spec: dict):
        """ADMIN swap body -> new packed weights: {"op": "swap", "model":
        <tenant>, "kind": mlp|conv (default: the tenant name), "seed": n}"""
        kind = spec.get("kind", spec.get("model", args.model))
        if kind not in ("mlp", "conv"):
            raise ValueError(f"unknown demo model kind {kind!r}")
        return build_demo_model(kind, smoke=args.smoke,
                                seed=int(spec.get("seed", 0))).pack(
            device=args.device)

    kinds = ([k.strip() for k in args.models.split(",") if k.strip()]
             if args.models else None)
    if kinds:
        registry = ModelRegistry(device=args.device)
        for kind in kinds:
            registry.register(
                kind, build_demo_model(kind, smoke=args.smoke).pack(
                    device=args.device),
                policy=BucketPolicy.for_mesh(n_shards), noise=noise)
        srv = SpikeSocketServer(
            registry, host=args.host, port=args.port, mesh=mesh,
            queue_capacity=args.queue_capacity,
            backpressure=args.backpressure,
            default_slack=args.default_slack, slo=slo,
            model_factory=model_factory)
        label = "+".join(kinds)
    else:
        packed = build_demo_model(args.model, smoke=args.smoke).pack(
            device=args.device)
        srv = SpikeSocketServer(
            packed, policy=BucketPolicy.for_mesh(n_shards),
            host=args.host, port=args.port, mesh=mesh,
            queue_capacity=args.queue_capacity,
            backpressure=args.backpressure,
            default_slack=args.default_slack, noise=noise, slo=slo,
            model_factory=model_factory)
        label = args.model
    host, port = srv.address
    names = srv.server.registry.names()
    where = "" if mesh is None else f"{mesh.size}-way mesh, "
    print(f"socket-serve/{label}: listening on {host}:{port} "
          f"(on {srv.server.packed.device}, {where}{len(names)} tenant(s): "
          f"{', '.join(names)})")

    if args.smoke:
        # best-effort requests: full buckets dispatch inline, the remainder
        # rides the idle-flush path — no deadline misses from first-call
        # wall time polluting a liveness check.  Multi-tenant smoke: traffic
        # to every tenant (plus one legacy v1 frame on the default route), a
        # live ADMIN hot-swap of the first tenant, then traffic onto the
        # swapped-in weights.
        per_model = 6
        plan = []        # (model | None, version, stream) per request
        for name in names:
            n_in = srv.server.registry.get(name).packed.n_in
            for i, s in enumerate(synth_requests(per_model, n_in,
                                                 t_hi=12, seed=1)):
                # first request of the default tenant goes out as a v1
                # frame: the pre-registry protocol must still be served
                legacy = (name == srv.server.registry.default and i == 0)
                plan.append((None if legacy else name,
                             1 if legacy else ingest.VERSION, s))
        swap_tenant = names[0]
        swap_kind = kinds[0] if kinds else args.model
        post_swap = synth_requests(
            per_model, srv.server.registry.get(swap_tenant).packed.n_in,
            t_hi=12, seed=2)
        n_results = len(plan) + len(post_swap)
        with serving_thread(srv, max_requests=n_results):
            cli = SpikeClient(host, port)
            for model, version, s in plan:
                cli.send(s, model=model, version=version)
            adm = cli.admin({"op": "swap", "model": swap_tenant,
                             "kind": swap_kind, "seed": 1})
            for s in post_swap:
                cli.send(s, model=swap_tenant)
            # observability round-trip while the loop is live: the full
            # metrics snapshot and a flight-recorder dump over the wire
            met = cli.admin({"op": "metrics"})
            trc = cli.admin({"op": "trace"})
            cli.recv_all()
            cli.close()
        snap = srv.server.metrics.snapshot()
        _check(len(cli.results) == n_results,
               f"served {len(cli.results)}/{n_results}")
        reply = cli.admin_replies[adm]
        _check(reply.get("ok") and reply.get("generation") == 2,
               f"swap reply {reply}")
        _check(snap["hot_swaps"] == 1 and snap["rejected"] == 0,
               f"hot_swaps {snap['hot_swaps']}, rejected {snap['rejected']}")
        mrep = cli.admin_replies[met]
        _check(mrep.get("ok") and set(mrep["metrics"]) == set(METRIC_KEYS),
               f"ADMIN metrics reply is not schema-locked: {sorted(mrep)}")
        trep = cli.admin_replies[trc]
        _check(trep.get("ok") and "anomaly_counts" in trep["dump"],
               f"ADMIN trace reply {sorted(trep)}")
        # every fault this smoke injected is a typed recorder anomaly
        counts = srv.tracer.anomaly_counts
        _check(counts.get("hot_swap_pin", 0) == 1, f"anomalies {counts}")
        per_done = ", ".join(
            f"{n}={mm['completed']}" for n, mm in snap["per_model"].items())
        print(f"socket-serve smoke: {snap['completed']} served across "
              f"{snap['models']} tenant(s) ({per_done}), "
              f"{snap['hot_swaps']} hot-swap, "
              f"p50 latency {snap['p50_latency_s']*1e3:.1f} ms, "
              f"miss rate {snap['deadline_miss_rate']:.3f}")
        return
    try:
        srv.serve()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
