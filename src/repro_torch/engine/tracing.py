"""Per-request span tracing + flight recorder for the serving fabric.

The serving stack already computes everything an operator needs to answer
"where did request X spend its time" — admission instants, scheduler
trigger decisions, per-dispatch :class:`~repro_torch.core.memories.DispatchStats`,
utilization, energy — and then throws it away at aggregate granularity:
25-odd ``METRIC_KEYS`` scalars and a bounded telemetry deque.  This module
is the measurement substrate underneath those aggregates (the
bottleneck-modeling argument of arXiv 2511.21549: optimization needs
measured per-stage breakdowns, not end-to-end averages):

  * :class:`RequestTrace` — one admitted request's life as typed
    :class:`Span` s (``admit -> queue -> schedule -> pad -> dispatch ->
    slice -> complete``, plus per-layer ``hw`` sub-spans carrying the
    dispatch counters and energy sampled from the engine results).  Every
    timestamp comes from the *server's* pluggable clock, so a
    :class:`~repro_torch.engine.stream_server.VirtualClock` replay produces
    byte-identical traces that tests golden-lock (``dump_json()``).
  * :class:`FlightRecorder` — a bounded ring buffer of the last N completed
    traces plus **every** anomalous one (deadline miss, shed, reject,
    device loss, hot-swap pin, noise-probe disagreement, policy extension
    — :data:`ANOMALY_KINDS`), with lifetime-exact ``anomaly_counts`` and a
    sorted-keys JSON ``dump()`` for on-demand or on-fault snapshots.  The
    chaos harness asserts every injected fault appears here as a typed
    anomaly.
  * :class:`Histogram` — fixed-bucket cumulative histograms
    (:data:`HIST_KEYS`: TTFD, clock-observed service time, end-to-end
    latency, bucket fill).  ``ServerMetrics`` percentiles are computed from
    these, so long soaks never silently forget the tail the way the
    bounded ``METRICS_WINDOW`` deque does; the windowed values survive
    under explicit ``recent_*`` keys.
  * :data:`STAGE_SPANS`, :func:`span` and :func:`stage_totals` live in
    :mod:`repro_torch.stage_spans` and are bound here too.

Determinism contract (tested, ``tests/test_torch_tracing.py``): two
``run_scenario`` replays of the same scenario yield byte-identical
``dump_json()``, and a tracer-on run is bit-exact (results *and* metrics)
with a tracer-off run — the observer effect on the served bits is zero.
Wall-clock measurements (``record["seconds"]``) never enter a trace.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math

# bound here too: the benchmark's readers read them from this module
from repro_torch.stage_spans import (STAGE_SPANS, span,  # noqa: F401
                                     stage_totals)

# The span taxonomy, in request-lifecycle order: the reference's tuple
# (tests/test_torch_tracing.py locks it) — dashboards parsing dumps key on
# these.
SPAN_KINDS = ("admit", "queue", "schedule", "pad", "dispatch", "slice",
              "hw", "complete")

# Typed anomaly kinds a FlightRecorder can record; every chaos-injected
# fault must surface as one of these.  Locked like SPAN_KINDS.
ANOMALY_KINDS = ("reject", "shed", "policy_extension", "deadline_miss",
                 "device_loss", "hot_swap_pin", "noise_disagreement")

# The cumulative-histogram set (FlightRecorder.hist and the histogram
# fields of ServerMetrics): time-to-first-dispatch, clock-observed service
# time per dispatch, end-to-end latency, and bucket fill ratio.
HIST_KEYS = ("ttfd_s", "service_s", "latency_s", "fill")

# Log-spaced time edges, 8 buckets/decade over [1 us, 100 s]: fine enough
# that a p99 read off a bucket's upper edge is within ~33% of exact, fixed
# so dumps from different runs/hosts are comparable bucket-for-bucket.
TIME_EDGES = tuple(10.0 ** (-6.0 + i / 8.0) for i in range(65))

# Linear edges for ratios in (0, 1] (bucket fill).
RATIO_EDGES = tuple((i + 1) / 32.0 for i in range(32))


class Histogram:
    """Fixed-bucket cumulative histogram with deterministic percentiles.

    ``add`` is O(log n_edges); ``percentile(q)`` returns the **upper edge**
    of the bucket holding the q-th sample (an upper bound on the true
    percentile, exact to one bucket width) — a pure function of the counts,
    so two runs that saw the same samples report identical percentiles.
    Unlike a bounded sample window, the counts are lifetime-exact: a
    million-request soak's p99 still reflects every request."""

    __slots__ = ("edges", "counts", "n", "total")

    def __init__(self, edges: tuple[float, ...] = TIME_EDGES):
        self.edges = tuple(float(e) for e in edges)
        assert self.edges and list(self.edges) == sorted(self.edges)
        # counts[i] holds values <= edges[i] (and > edges[i-1]); the final
        # slot is the overflow bucket for values beyond the last edge
        self.counts = [0] * (len(self.edges) + 1)
        self.n = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.n += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket containing the q-th percentile sample
        (overflow clamps to the last edge); 0.0 when empty."""
        if not self.n:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]

    def to_dict(self) -> dict:
        """JSON-ready summary: sparse nonzero bucket counts (keyed by
        bucket index into the fixed edge grid) plus n/mean/p50/p99."""
        return {"n": int(self.n), "mean": float(self.mean),
                "p50": float(self.percentile(50)),
                "p99": float(self.percentile(99)),
                "counts": {str(i): int(c)
                           for i, c in enumerate(self.counts) if c}}


def _jsonable(v):
    """Coerce span/anomaly attribute values to plain JSON scalars (numpy
    ints/floats sneak in from stats aggregation; inf has no strict-JSON
    encoding, so best-effort deadlines are dropped by callers)."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    if hasattr(v, "item"):            # numpy scalar
        return _jsonable(v.item())
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


@dataclasses.dataclass
class Span:
    """One typed interval of a request's life, on the server's clock.
    ``t0 == t1`` is a point event (every execute-side span under a
    VirtualClock, which does not advance inside an engine call)."""

    kind: str
    t0: float
    t1: float
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "t0": float(self.t0),
                "t1": float(self.t1),
                "attrs": {k: _jsonable(v) for k, v in self.attrs.items()}}


@dataclasses.dataclass
class RequestTrace:
    """Every span and anomaly of one admitted request, pinned to the
    (model, generation) it was admitted under."""

    rid: int
    model: str
    generation: int
    arrival_t: float
    spans: list[Span] = dataclasses.field(default_factory=list)
    anomalies: list[dict] = dataclasses.field(default_factory=list)
    completed: bool = False
    end_t: float | None = None

    def to_dict(self) -> dict:
        return {"rid": int(self.rid), "model": self.model,
                "generation": int(self.generation),
                "arrival_t": float(self.arrival_t),
                "completed": bool(self.completed),
                "end_t": None if self.end_t is None else float(self.end_t),
                "spans": [s.to_dict() for s in self.spans],
                "anomalies": list(self.anomalies)}


class FlightRecorder:
    """Bounded in-memory trace store for an always-on server.

    ``keep_completed`` recent completed traces ride a ring buffer;
    anomalous traces (any trace carrying an anomaly, plus every aborted
    one) ride their own larger ring so a burst of healthy traffic cannot
    evict the evidence of a fault.  Server-level anomalies with no request
    attached (admission-time rejects, device loss, hot-swap pins) land in
    ``events``.  ``anomaly_counts`` is lifetime-exact.  All mutators are
    no-ops for unknown rids, so a recorder attached mid-flight never
    raises out of the serving loop."""

    def __init__(self, keep_completed: int = 64, keep_anomalous: int = 256,
                 keep_events: int = 1024):
        self.active: dict[int, RequestTrace] = {}
        self.completed: collections.deque[RequestTrace] = \
            collections.deque(maxlen=keep_completed)
        self.anomalous: collections.deque[RequestTrace] = \
            collections.deque(maxlen=keep_anomalous)
        self.events: collections.deque[dict] = \
            collections.deque(maxlen=keep_events)
        self.anomaly_counts: dict[str, int] = {}
        self.hist: dict[str, Histogram] = {
            "ttfd_s": Histogram(TIME_EDGES),
            "service_s": Histogram(TIME_EDGES),
            "latency_s": Histogram(TIME_EDGES),
            "fill": Histogram(RATIO_EDGES),
        }
        assert tuple(self.hist) == HIST_KEYS
        self.n_started = 0
        self.n_completed = 0

    # ---------------------------------------------------------- lifecycle

    def start(self, rid: int, *, model: str, generation: int,
              t: float) -> RequestTrace:
        tr = RequestTrace(rid=int(rid), model=model,
                          generation=int(generation), arrival_t=float(t))
        self.active[rid] = tr
        self.n_started += 1
        return tr

    def span(self, rid: int, kind: str, t0: float, t1: float,
             **attrs) -> None:
        tr = self.active.get(rid)
        if tr is not None:
            tr.spans.append(Span(kind=kind, t0=float(t0), t1=float(t1),
                                 attrs=attrs))

    def complete(self, rid: int, t: float) -> None:
        tr = self.active.pop(rid, None)
        if tr is None:
            return
        tr.completed = True
        tr.end_t = float(t)
        self.n_completed += 1
        self.completed.append(tr)
        if tr.anomalies:
            self.anomalous.append(tr)

    def abort(self, rid: int, t: float) -> None:
        """A traced request that will never complete (shed from the
        queue): always anomalous, never in the completed ring."""
        tr = self.active.pop(rid, None)
        if tr is None:
            return
        tr.end_t = float(t)
        self.anomalous.append(tr)

    def anomaly(self, kind: str, *, t: float, rid: int | None = None,
                **attrs) -> None:
        """Record a typed anomaly — attached to ``rid``'s trace when it is
        still known (active, completed, or already anomalous; late
        anomalies like a post-completion noise-probe disagreement promote
        the trace into the anomalous ring), else as a server-level
        event."""
        assert kind in ANOMALY_KINDS, f"unknown anomaly kind {kind!r}"
        self.anomaly_counts[kind] = self.anomaly_counts.get(kind, 0) + 1
        rec = {"kind": kind, "t": float(t),
               "rid": None if rid is None else int(rid)}
        rec.update({k: _jsonable(v) for k, v in attrs.items()})
        tr = None if rid is None else self.trace(rid)
        if tr is None:
            self.events.append(rec)
            return
        tr.anomalies.append(rec)
        if tr.rid not in self.active and \
                not any(t2 is tr for t2 in self.anomalous):
            self.anomalous.append(tr)

    def observe(self, key: str, value: float) -> None:
        self.hist[key].add(value)

    # ------------------------------------------------------------ queries

    def trace(self, rid: int) -> RequestTrace | None:
        """Find a trace by rid — active first, then the rings."""
        tr = self.active.get(rid)
        if tr is not None:
            return tr
        for ring in (self.completed, self.anomalous):
            for t in reversed(ring):
                if t.rid == rid:
                    return t
        return None

    def last(self) -> RequestTrace | None:
        """The most recently completed trace."""
        return self.completed[-1] if self.completed else None

    def dump(self) -> dict:
        """The full deterministic snapshot: completed + anomalous rings,
        server-level events, lifetime anomaly counts, and the cumulative
        histograms.  Everything inside comes off the server's clock —
        under a VirtualClock two replays of the same trace produce
        identical dumps (wall seconds are excluded for exactly this
        reason)."""
        return {
            "n_started": int(self.n_started),
            "n_completed": int(self.n_completed),
            "completed": [t.to_dict() for t in self.completed],
            "anomalous": [t.to_dict() for t in self.anomalous],
            "events": list(self.events),
            "anomaly_counts": {k: int(v) for k, v in
                               sorted(self.anomaly_counts.items())},
            "histograms": {k: h.to_dict() for k, h in self.hist.items()},
        }

    def dump_json(self) -> str:
        """Sorted-keys JSON of :meth:`dump` — the byte-comparable form the
        determinism tests compare."""
        return json.dumps(self.dump(), sort_keys=True)
