"""Always-on async serving loop: arrival-driven continuous batching.

``run_bucketed`` drains a *closed* list of requests; production DVS traffic
from edge sensors is an open stream.  :class:`StreamServer` is the always-on
front end for that stream:

  * **Arrival queue with admission control.**  ``submit`` admits one request
    at the current clock time.  The queue is bounded (``queue_capacity``);
    an arrival that would overflow it is either rejected or sheds the oldest
    pending request of the most-backlogged tenant (``backpressure="reject" |
    "shed_oldest"``).  Requests longer than the policy's largest time bucket
    are rejected at admission with a per-request reason — or, with
    ``overlong="extend"``, grow the bucket grid geometrically (a new engine
    shape, logged) instead.
  * **Multi-tenant model fabric.**  MENAGE's virtual neuron time-multiplexes
    many model neurons onto one physical engine; the server applies the same
    idea one level up and time-multiplexes many *models* onto one executor.
    Tenants live in a :class:`~repro_torch.engine.registry.ModelRegistry` — each
    with its own packed weights, :class:`BucketPolicy`, noise config, and
    weighted-fair share — and ``submit(stream, model="name")`` routes to
    them.  Requests pin the (model, generation) they were admitted under, so
    a :meth:`swap` (hot-swap: drain the tenant's in-flight groups on the old
    weights, then atomically redirect new submits to the new ones) never
    loses or corrupts a request.  Between due groups the scheduler picks by
    weighted-fair virtual time, then deadline — one tenant's burst cannot
    starve another's deadlines.  A single ``StreamServer(packed, policy=p)``
    still works: it becomes a one-tenant registry behind the scenes.
  * **Deadline-aware batch formation.**  Pending requests group by (model,
    generation, time bucket).  A group dispatches the moment it can fill a
    ``max_batch`` chunk — or *earlier*, partially full, when the oldest
    member's deadline slack (deadline − now − estimated service time −
    ``dispatch_margin``) runs out.  This is the fix for the batch-formation
    stall of event-driven dispatch (Yik et al. 2025): a short request never
    waits for a bucket that might not fill.
  * **Bit-exact execution.**  A formed batch runs through the *same*
    :func:`repro_torch.engine.serving.execute_plan` as the closed-list
    path — zero-pad into the policy bucket, ``run_batched``, slice each
    request back out — so every served result is bit-identical to
    ``run_bucketed``'s *on the packed model that was serving the tenant at
    dispatch time* and hence to the numpy oracle (tested,
    ``tests/test_torch_stream_server.py``, ``tests/test_torch_registry.py``).
    The engine's shapes stay bounded by the sum of per-tenant
    ``policy.n_buckets`` by construction (same-shape hot-swaps add none),
    and with ``donate`` on so do its input buffers: one per bucket.
  * **Metrics.**  :class:`ServerMetrics` tracks queue depth,
    time-to-first-dispatch, end-to-end latency percentiles, deadline-miss
    rate, bucket fill ratio, and a per-model sub-table
    (:data:`PER_MODEL_KEYS`), the reference's schema.
  * **Chaos-ready.**  Production failure modes are first-class
    (:mod:`repro_torch.engine.chaos` drives them): a ``chaos_hook`` may
    raise :class:`~repro_torch.engine.sharded_run.DeviceLossError` at any
    dispatch boundary and the server recovers onto the shrunken ``mesh``
    (elastic serving: every admitted request is still served), while
    without a mesh a device loss is fatal; an :class:`SLOPolicy` flips
    between extend-biased admission and shedding on the windowed
    deadline-miss rate; and
    ``noise=AnalogNoise(...)`` serves through one deterministic noisy
    device instance with periodic shadow probes against the clean model
    (the ``noise_agreement`` accuracy-under-noise metric).  Every scenario
    replays deterministically on a VirtualClock
    (tests/test_torch_chaos.py).

Time is pluggable: the default :class:`WallClock` serves real traffic;
:class:`VirtualClock` + :func:`serve_trace` replay a time-stamped arrival
trace deterministically (the clock only moves between arrivals and at
deadline-trigger instants), which is what makes the scheduler's dispatch
decisions unit-testable and the benchmark reproducible.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import time

import numpy as np

from repro_torch.engine import batched_run as br
from repro_torch.engine.registry import (DEFAULT_MODEL, ModelEntry,  # noqa: F401
                                         ModelRegistry, UnknownModelError)
from repro_torch.engine.serving import (BatchPlan, BucketPolicy,
                                        RequestResult, execute_plan)
from repro_torch.engine.sharded_run import DeviceLossError, shrink_mesh
from repro_torch.engine.tracing import TIME_EDGES, FlightRecorder, Histogram

_log = logging.getLogger(__name__)


# ------------------------------------------------------------------- clocks

class WallClock:
    """Real time — the production configuration."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """Manually-advanced time for deterministic replay of arrival traces."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0.0, f"time cannot run backwards (dt={dt})"
        self._t += dt


# ----------------------------------------------------------------- requests

@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted in-flight request, pinned to the (model, generation) it
    was admitted under — a hot-swap cannot change which weights serve it."""

    rid: int
    stream: np.ndarray          # [T_i, n_in]
    arrival_t: float
    deadline: float             # absolute; math.inf = best-effort
    t_pad: int                  # time bucket it was admitted into
    model: str = DEFAULT_MODEL
    generation: int = 1


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Why a request never produced a result: ``queue_full`` (bounded-queue
    backpressure), ``shed`` (displaced by a newer arrival under
    ``backpressure="shed_oldest"``), or ``overlong`` (admission control).
    ``model`` is the tenant the request targeted (None when it never
    resolved to one)."""

    rid: int | None             # None when rejected before admission
    reason: str
    detail: str
    at: float
    model: str | None = None


# ------------------------------------------------------------------ metrics

# Always-on means unbounded time: per-request samples (latency, TTFD, fill)
# and the telemetry/rejection logs keep the most recent WINDOW entries, so a
# long-lived server reports sliding-window percentiles at O(1) memory
# instead of growing until OOM.  Counters are exact over the full lifetime.
METRICS_WINDOW = 10_000

# The ServerMetrics.snapshot() schema: the reference's tuple, locked equal
# to it by tests/test_torch_stream_server.py so dashboards read both alike.
METRIC_KEYS = (
    "submitted", "admitted", "rejected", "shed", "completed",
    "deadline_misses", "deadline_miss_rate", "dispatches",
    "forced_dispatches", "policy_extensions", "queue_depth",
    "max_queue_depth", "bucket_fill_ratio", "p50_ttfd_s", "p99_ttfd_s",
    "p50_latency_s", "p99_latency_s", "recent_p50_ttfd_s",
    "recent_p99_ttfd_s", "recent_p50_latency_s", "recent_p99_latency_s",
    "device_losses", "slo_switches", "slo_shedding", "noise_probes",
    "noise_agreement", "models", "hot_swaps", "per_model")

# The per-tenant sub-table under snapshot()["per_model"], locked like
# METRIC_KEYS.
PER_MODEL_KEYS = (
    "submitted", "admitted", "rejected", "shed", "completed",
    "deadline_misses", "deadline_miss_rate", "dispatches", "hot_swaps",
    "p50_latency_s", "p99_latency_s", "recent_p50_latency_s",
    "recent_p99_latency_s")


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class ModelMetrics:
    """Per-tenant slice of the serving counters (``PER_MODEL_KEYS``).
    ``p50/p99_latency_s`` come from a lifetime cumulative histogram (exact
    over every completed request); the windowed deque percentiles survive
    as ``recent_*``."""

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    shed: int = 0
    completed: int = 0
    deadline_misses: int = 0
    dispatches: int = 0
    hot_swaps: int = 0
    latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=METRICS_WINDOW))
    latency_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(TIME_EDGES))

    def observe_latency(self, dt: float) -> None:
        self.latency_s.append(dt)
        self.latency_hist.add(dt)

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "shed": self.shed,
            "completed": self.completed,
            "deadline_misses": self.deadline_misses,
            "deadline_miss_rate": (self.deadline_misses / self.completed
                                   if self.completed else 0.0),
            "dispatches": self.dispatches,
            "hot_swaps": self.hot_swaps,
            "p50_latency_s": self.latency_hist.percentile(50),
            "p99_latency_s": self.latency_hist.percentile(99),
            "recent_p50_latency_s": _pct(self.latency_s, 50),
            "recent_p99_latency_s": _pct(self.latency_s, 99),
        }


@dataclasses.dataclass
class ServerMetrics:
    """Serving-loop counters plus per-request latency samples.

    ``snapshot()`` reduces to the fixed ``METRIC_KEYS`` dict: queue depth
    (current/max), time-to-first-dispatch and end-to-end latency
    percentiles, deadline-miss rate over completed requests, the mean
    bucket fill ratio (requests per dispatch / padded batch rows — how much
    of each engine call was real work), and the ``per_model`` sub-table
    keyed by tenant name (each row is ``PER_MODEL_KEYS``).  Counters are
    lifetime-exact.  ``p50/p99_*`` percentiles come from lifetime
    cumulative :class:`~repro_torch.engine.tracing.Histogram` s — a week-long
    soak's p99 reflects every request, not just the last
    ``METRICS_WINDOW``; the windowed sliding values are exported under
    explicit ``recent_*`` keys (and fill stays a windowed mean)."""

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    shed: int = 0
    completed: int = 0
    deadline_misses: int = 0
    dispatches: int = 0
    forced_dispatches: int = 0      # deadline-triggered partial dispatches
    policy_extensions: int = 0
    queue_depth: int = 0
    max_queue_depth: int = 0
    device_losses: int = 0          # chaos/watchdog-reported mesh shrinks
    slo_switches: int = 0           # shed<->extend mode flips by the SLO loop
    slo_shedding: bool = False      # currently in degraded (shedding) mode
    noise_probes: int = 0           # requests shadow-checked vs clean model
    noise_disagreements: int = 0    # probes whose prediction flipped
    hot_swaps: int = 0              # registry generations installed live
    per_model: dict = dataclasses.field(default_factory=dict)
    ttfd_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=METRICS_WINDOW))
    latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=METRICS_WINDOW))
    fill: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=METRICS_WINDOW))
    ttfd_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(TIME_EDGES))
    latency_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(TIME_EDGES))

    def model(self, name: str) -> ModelMetrics:
        """The (auto-created) per-tenant counter row for ``name``."""
        mm = self.per_model.get(name)
        if mm is None:
            mm = self.per_model[name] = ModelMetrics()
        return mm

    def observe_ttfd(self, dt: float) -> None:
        self.ttfd_s.append(dt)
        self.ttfd_hist.add(dt)

    def observe_latency(self, dt: float) -> None:
        self.latency_s.append(dt)
        self.latency_hist.add(dt)

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "shed": self.shed,
            "completed": self.completed,
            "deadline_misses": self.deadline_misses,
            "deadline_miss_rate": (self.deadline_misses / self.completed
                                   if self.completed else 0.0),
            "dispatches": self.dispatches,
            "forced_dispatches": self.forced_dispatches,
            "policy_extensions": self.policy_extensions,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "bucket_fill_ratio": (float(np.mean(self.fill))
                                  if self.fill else 0.0),
            "p50_ttfd_s": self.ttfd_hist.percentile(50),
            "p99_ttfd_s": self.ttfd_hist.percentile(99),
            "p50_latency_s": self.latency_hist.percentile(50),
            "p99_latency_s": self.latency_hist.percentile(99),
            "recent_p50_ttfd_s": _pct(self.ttfd_s, 50),
            "recent_p99_ttfd_s": _pct(self.ttfd_s, 99),
            "recent_p50_latency_s": _pct(self.latency_s, 50),
            "recent_p99_latency_s": _pct(self.latency_s, 99),
            "device_losses": self.device_losses,
            "slo_switches": self.slo_switches,
            "slo_shedding": int(self.slo_shedding),
            "noise_probes": self.noise_probes,
            # accuracy under analog noise: fraction of shadow-probed
            # requests whose prediction matched the clean model (1.0 when
            # probing is off — no evidence of degradation)
            "noise_agreement": ((self.noise_probes - self.noise_disagreements)
                                / self.noise_probes
                                if self.noise_probes else 1.0),
            "models": len(self.per_model),
            "hot_swaps": self.hot_swaps,
            "per_model": {name: mm.snapshot()
                          for name, mm in sorted(self.per_model.items())},
        }


# ------------------------------------------------------------------- server

_EWMA_ALPHA = 0.3


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """SLO-driven shed-vs-extend switching for an always-on server.

    The server normally runs *extend-biased*: whatever ``backpressure`` /
    ``overlong`` it was built with (typically admit-everything).  When the
    deadline-miss rate over the last ``window`` completed requests exceeds
    ``target_miss_rate``, it flips to *shed* mode — ``backpressure=
    "shed_oldest"`` (newest data wins; stale queued requests would miss
    anyway) and ``overlong="reject"`` (no mid-overload grid growth, which
    costs a new engine shape at the worst possible moment).  Once the windowed
    rate drops below ``restore_factor * target_miss_rate``, the original
    policies are restored.  Mode flips are counted in the ``slo_switches``
    metric and the current mode is exported as ``slo_shedding`` — the
    measured, scenario-driven alternative to hand-tuning backpressure per
    deployment (cf. the bottleneck-modeling argument of arXiv 2511.21549).
    """

    target_miss_rate: float = 0.05
    window: int = 64
    min_samples: int = 16          # don't flap on the first few requests
    restore_factor: float = 0.5

    def __post_init__(self):
        assert 0.0 < self.target_miss_rate <= 1.0
        assert 0.0 <= self.restore_factor < 1.0
        assert 0 < self.min_samples <= self.window


class StreamServer:
    """The always-on continuous-batching loop (module docstring has the
    design).  Drive it with :meth:`submit` on arrival, :meth:`poll` when
    time passes (:meth:`next_deadline` says when that matters), and
    :meth:`flush` at shutdown; completed ``(rid, RequestResult)`` pairs
    come back from ``poll``/``flush``.

    ``model`` is either a single packed/mapped model (a one-tenant fabric
    with per-server ``policy``/``noise`` — the original API; a mapped model
    is packed onto the card) or a
    :class:`~repro_torch.engine.registry.ModelRegistry` (multi-tenant;
    policy and noise then live on the entries and the ``policy``/``noise``
    kwargs must stay unset).  :meth:`swap` hot-swaps a tenant's weights
    live.  ``mesh`` (a :class:`~repro_torch.engine.sharded_run.ServeMesh`)
    serves every dispatch sharded over its devices and makes a device loss
    recoverable; ``None`` serves on the model's device, where a device loss
    is fatal.
    """

    def __init__(self, model, *, policy: BucketPolicy | None = None,
                 mesh=None, clock=None,
                 queue_capacity: int = 256,
                 backpressure: str = "reject",
                 overlong: str = "reject",
                 default_slack: float = math.inf,
                 dispatch_margin: float = 0.0,
                 service_model=None,
                 max_events: int | None = None,
                 sn_capacity_rows: int | None = None,
                 with_stats: bool = False,
                 donate: bool | None = None,
                 noise=None, noise_key=0, noise_probe_every: int = 8,
                 slo: SLOPolicy | None = None,
                 chaos_hook=None, on_rejection=None, on_completion=None,
                 tracer: FlightRecorder | None = None):
        assert backpressure in ("reject", "shed_oldest"), backpressure
        assert overlong in ("reject", "extend"), overlong
        assert queue_capacity > 0
        assert noise_probe_every >= 0
        if isinstance(model, ModelRegistry):
            assert policy is None and noise is None, \
                "a multi-tenant server takes per-model policy/noise from " \
                "its registry entries, not from server kwargs"
            assert len(model) > 0, "registry has no models to serve"
            self.registry = model
        else:
            assert policy is not None, "single-model servers need a policy"
            self.registry = ModelRegistry()
            # serving-time analog noise: serve every request through one
            # deterministic noisy device instance (core/noise.perturb_packed);
            # every noise_probe_every-th dispatch is shadow-replayed through
            # the clean model to track prediction agreement (the
            # accuracy-under-noise metric).  0 disables probing.
            self.registry.register(DEFAULT_MODEL, model, policy=policy,
                                   noise=noise, noise_key=noise_key)
        self.noise_probe_every = noise_probe_every
        # SLO controller state: the configured backpressure/overlong are the
        # "extend-biased" baseline it restores to after a shed episode
        self.slo = slo
        self._slo_base = (backpressure, overlong)
        self._slo_misses: collections.deque = collections.deque(
            maxlen=slo.window if slo is not None else 1)
        # chaos_hook(dispatch_ordinal) runs at every dispatch boundary and
        # may raise DeviceLossError — the soak harness's failure injection,
        # mirroring train_loop's failure_hook
        self.chaos_hook = chaos_hook
        self.mesh = mesh
        self.clock = clock if clock is not None else WallClock()
        self.queue_capacity = queue_capacity
        self.backpressure = backpressure
        self.overlong = overlong
        self.default_slack = default_slack
        self.dispatch_margin = dispatch_margin
        # service_model(b_pad, t_pad) -> seconds: the scheduler's estimate of
        # one engine call on that bucket.  None = learn an EWMA from measured
        # wall seconds.  On a VirtualClock the model also *advances* the
        # clock per dispatch, turning the server into a deterministic
        # discrete-event simulation grounded in calibrated timings.
        self.service_model = service_model
        self.max_events = max_events
        self.sn_capacity_rows = sn_capacity_rows
        self.with_stats = with_stats
        # each dispatch uploads one padded bucket; with donate on it is
        # copied into that bucket's preallocated device buffer, so an
        # always-on server holds at most n_buckets input buffers per model
        # instead of allocating one per dispatch.  Default: on for a CUDA
        # model, off on the CPU.
        self.donate = br.should_donate(
            donate, mesh.devices[0] if mesh is not None
            else self.registry.get().packed.device)
        # on_rejection(Rejection) fires synchronously for every rejection
        # as it happens — the delivery channel for transports that must
        # answer displaced clients.
        # The `rejections` deque below is a bounded *metrics* window and
        # can overflow under sustained shedding; consumers that may not
        # lose a record subscribe here instead of scraping it.
        self.on_rejection = on_rejection
        # on_completion(rid, result) fires synchronously as each result
        # completes, with the clock already advanced past the service
        # period — observers (benchmarks, transports) read per-request
        # completion instants off self.now() without polling collect().
        self.on_completion = on_completion
        # tracer: a FlightRecorder (repro_torch.engine.tracing) receiving a typed
        # span trace for every admitted request plus typed anomalies for
        # every fault.  All span times come off self.clock, so a
        # VirtualClock replay produces byte-identical dumps; None = tracing
        # off, with zero observable effect on served bits (tested).
        self.tracer = tracer
        if tracer is not None:
            tracer.attach_jit_probe()
        self.metrics = ServerMetrics()
        # execute_plan records / rejection log, last METRICS_WINDOW entries
        self.telemetry: collections.deque = \
            collections.deque(maxlen=METRICS_WINDOW)
        self.rejections: collections.deque = \
            collections.deque(maxlen=METRICS_WINDOW)
        # scheduler state.  Pending groups key by (model, generation,
        # t_pad): the generation pin is what makes hot-swap unable to
        # corrupt a queued request — its group still points at the entry it
        # was admitted under.  Runtime bucket policies are per tenant and
        # mutable (overlong=extend growth); registry entries keep the
        # pristine configured policy.
        self._pending: dict[tuple[str, int, int],
                            collections.deque[Request]] = {}
        self._entries: dict[tuple[str, int], ModelEntry] = {}
        self._policies: dict[str, BucketPolicy] = {}
        self._n_pending = 0
        self._n_pending_by: dict[str, int] = {}
        self._completed: list[tuple[int, RequestResult]] = []
        self._next_rid = 0
        # per-(model, b_pad, t_pad) EWMA service estimates.  Keying by model
        # matters: tenants of very different sizes can share a bucket shape
        # but differ 10x in service time — a shared key would cross-pollute
        # both schedulers' deadline triggers.
        self._ewma: dict[tuple[str, int, int], float] = {}
        # weighted-fair virtual time per tenant: advanced by
        # service/weight on each dispatch, used to order due groups so a
        # flooding tenant cannot starve the others (see _due_order)
        self._vtime: dict[str, float] = {}
        self._vglobal = 0.0
        for name in self.registry.names():
            self.metrics.model(name)

    # -------------------------------------------------------------- tenants

    @property
    def packed(self) -> br.PackedModel:
        """The default tenant's serving weights (single-model API)."""
        return self.registry.get().packed

    @property
    def _clean_packed(self) -> br.PackedModel:
        return self.registry.get().clean

    @property
    def noise(self):
        return self.registry.get().noise

    @property
    def policy(self) -> BucketPolicy:
        """The default tenant's *runtime* bucket policy (single-model API:
        reflects overlong-extension growth)."""
        return self._policy_for(self.registry.default)

    def _policy_for(self, name: str) -> BucketPolicy:
        p = self._policies.get(name)
        if p is None:
            p = self._policies[name] = self.registry.get(name).policy
        return p

    def _entry_for(self, key: tuple[str, int]) -> ModelEntry:
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self.registry.get(key[0])
            assert entry.generation == key[1]
        return entry

    def swap(self, name: str, model, *, policy: BucketPolicy | None = None,
             noise=None, noise_key=0, weight: float | None = None,
             _inherit_noise: bool = True) -> ModelEntry:
        """Hot-swap tenant ``name`` onto new weights with zero lost
        requests: (1) drain — every group still pending on the old
        generation dispatches *now, on the old weights* (results land in
        the normal completion queue; collect them via :meth:`poll` /
        :meth:`collect`); (2) atomically install the new generation in the
        registry, so every later ``submit`` runs on the new weights; (3)
        drop only this tenant's EWMA calibration (it described the old
        weights).  Policy defaults to the tenant's current *runtime* policy
        — extension growth survives the swap.  Noise
        config is inherited unless explicitly overridden."""
        self.registry.get(name)                 # raise before side effects
        # Drain on the old weights.  flush() pops everything completed so
        # far out of the completion queue (collect() rebinds the list, so
        # extend must run *after* flush returns); put it all back — swap()
        # must not eat results the caller has yet to collect().
        drained = self.flush(model=name)
        self._completed.extend(drained)
        new_policy = policy if policy is not None else self._policy_for(name)
        kw = {} if (_inherit_noise and noise is None) else \
            {"noise": noise, "noise_key": noise_key}
        entry = self.registry.swap(name, model, policy=new_policy,
                                   weight=weight, **kw)
        self._policies[name] = new_policy
        self._entries[(name, entry.generation)] = entry
        self.clear_service_estimates(name)
        self.metrics.hot_swaps += 1
        self.metrics.model(name).hot_swaps += 1
        if self.tracer is not None:
            # generation pin: in-flight work drained on the old weights
            self.tracer.anomaly("hot_swap_pin", t=self.now(), model=name,
                                generation=entry.generation,
                                drained=len(drained))
        _log.info("stream_server: hot-swapped model %r to generation %d "
                  "(drained on old weights; new submits redirected)",
                  name, entry.generation)
        return entry

    def clear_service_estimates(self, model: str | None = None) -> None:
        """Drop learned EWMA service times — for one tenant (its weights or
        calibration went stale) or all (``None``)."""
        if model is None:
            self._ewma.clear()
        else:
            for k in [k for k in self._ewma if k[0] == model]:
                del self._ewma[k]

    # ------------------------------------------------------------ admission

    def now(self) -> float:
        return self.clock.now()

    @property
    def queue_depth(self) -> int:
        return self._n_pending

    def _reject(self, rid: int | None, reason: str, detail: str,
                model: str | None = None) -> None:
        rej = Rejection(rid=rid, reason=reason, detail=detail, at=self.now(),
                        model=model)
        self.rejections.append(rej)
        mm = self.metrics.model(model) if model is not None else None
        if reason == "shed":
            self.metrics.shed += 1
            if mm is not None:
                mm.shed += 1
        else:
            self.metrics.rejected += 1
            if mm is not None:
                mm.rejected += 1
        if self.tracer is not None:
            kind = "shed" if reason == "shed" else "reject"
            self.tracer.anomaly(kind, t=rej.at, rid=rid, reason=reason,
                                detail=detail, model=model)
            if rid is not None:
                # the admitted trace will never complete — park it in the
                # recorder's anomalous ring
                self.tracer.abort(rid, t=rej.at)
        if self.on_rejection is not None:
            self.on_rejection(rej)

    def _shed_oldest(self) -> None:
        """Backpressure by displacement: drop the oldest pending request of
        the tenant with the deepest backlog.  Shedding the *flooding*
        tenant's work (rather than the globally oldest request) is what
        keeps one tenant's burst from evicting everybody else's queue."""
        victim_name = max(
            (n for n, c in self._n_pending_by.items() if c > 0),
            key=lambda n: (self._n_pending_by[n], n))
        key = min((q[0].arrival_t, k) for k, q in self._pending.items()
                  if q and k[0] == victim_name)[1]
        victim = self._pending[key].popleft()
        self._n_pending -= 1
        self._n_pending_by[victim_name] -= 1
        self._reject(victim.rid, "shed",
                     f"displaced after {self.now() - victim.arrival_t:.3g}s "
                     f"in queue (capacity {self.queue_capacity})",
                     model=victim_name)

    def submit(self, stream, *, model: str | None = None,
               deadline: float | None = None,
               slack: float | None = None,
               arrival_t: float | None = None) -> int | None:
        """Admit one request for tenant ``model`` (None = the registry's
        default route) at the current clock time.  Returns its rid, or
        ``None`` if it was rejected (recorded in :attr:`rejections`).  The
        deadline is absolute; ``slack`` is relative to now; neither given
        falls back to ``default_slack``.  A group that reaches the tenant's
        ``max_batch`` dispatches immediately — collect results via
        :meth:`poll`.  An unregistered model name raises
        :class:`~repro_torch.engine.registry.UnknownModelError` (a typed
        error transports map to a rejection).

        ``arrival_t`` back-dates the request's arrival for latency/TTFD
        accounting (≤ now): on a virtual clock a request that physically
        arrived while the executor was busy is only admitted once the
        engine call returns, but its latency still counts from when the
        sensor produced it."""
        entry = self.registry.get(model)    # raises UnknownModelError
        name = entry.name
        now = self.now()
        if arrival_t is None:
            arrival_t = now
        assert arrival_t <= now + 1e-9, \
            f"arrival_t {arrival_t} is in the future (now={now})"
        self.metrics.submitted += 1
        mm = self.metrics.model(name)
        mm.submitted += 1
        stream = np.asarray(stream, dtype=np.float32)
        # a real raise, not an assert: submit is the boundary where
        # external traffic enters, so the shape check must survive -O and
        # give transports a typed error to map to a rejection
        if stream.ndim != 2 or stream.shape[1] != entry.packed.n_in:
            raise ValueError(
                f"expected [T, {entry.packed.n_in}] for model {name!r}, "
                f"got {stream.shape}")
        t_len = stream.shape[0]
        if t_len == 0:
            self._reject(None, "empty", "zero-length spike train", model=name)
            return None
        policy = self._policy_for(name)
        needs_extend = not policy.fits(t_len)
        if needs_extend and self.overlong == "reject":
            self._reject(None, "overlong",
                         f"{t_len} steps > largest time bucket "
                         f"{policy.time_steps[-1]}", model=name)
            return None
        if self._n_pending >= self.queue_capacity:
            if self.backpressure == "reject":
                self._reject(None, "queue_full",
                             f"queue at capacity {self.queue_capacity}",
                             model=name)
                return None
            self._shed_oldest()
        # grid extension is a side effect (a new engine shape) — apply it
        # only once the request is actually admitted
        if needs_extend:
            policy = policy.with_time_bucket(t_len)
            self._policies[name] = policy
            self.metrics.policy_extensions += 1
            if self.tracer is not None:
                self.tracer.anomaly("policy_extension", t=now, model=name,
                                    time_steps=list(policy.time_steps))
            _log.warning("stream_server: %d-step request extended model "
                         "%r's bucket grid to time_steps=%s (new shape)",
                         t_len, name, policy.time_steps)
        rid = self._next_rid
        self._next_rid += 1
        if deadline is None:
            s = self.default_slack if slack is None else slack
            deadline = arrival_t + s
        req = Request(rid=rid, stream=stream, arrival_t=arrival_t,
                      deadline=deadline, t_pad=policy.t_bucket(t_len),
                      model=name, generation=entry.generation)
        key = (name, entry.generation, req.t_pad)
        self._entries.setdefault((name, entry.generation), entry)
        if self._n_pending_by.get(name, 0) == 0:
            # fair-queueing catch-up: an idle tenant resumes at the fabric's
            # current virtual time instead of spending banked idle credit
            # monopolizing the executor
            self._vtime[name] = max(self._vtime.get(name, 0.0), self._vglobal)
        self._pending.setdefault(key, collections.deque()).append(req)
        self._n_pending += 1
        self._n_pending_by[name] = self._n_pending_by.get(name, 0) + 1
        self.metrics.admitted += 1
        mm.admitted += 1
        self.metrics.queue_depth = self._n_pending
        self.metrics.max_queue_depth = max(self.metrics.max_queue_depth,
                                           self._n_pending)
        if self.tracer is not None:
            self.tracer.start(rid, model=name, generation=entry.generation,
                              t=arrival_t)
            attrs = {"t_steps": int(t_len), "t_pad": int(req.t_pad),
                     "queue_depth": self._n_pending}
            if deadline != math.inf:
                attrs["deadline"] = float(deadline)
            self.tracer.span(rid, "admit", arrival_t, now, **attrs)
        if len(self._pending[key]) >= policy.max_batch:
            self._dispatch(key, policy.max_batch, forced=False)
        return rid

    # ----------------------------------------------------------- scheduling

    def _est_service(self, name: str, b_pad: int, t_pad: int) -> float:
        if self.service_model is not None:
            return float(self.service_model(b_pad, t_pad))
        return self._ewma.get((name, b_pad, t_pad), 0.0)

    def _trigger_time(self, key: tuple[str, int, int]) -> float:
        """When the group forces a (possibly partial) dispatch: its
        *tightest* member deadline minus the estimated service time for the
        batch we would form now, minus the safety margin.  (Tightest, not
        oldest: a best-effort ``inf``-deadline request admitted first must
        not mask a deadline behind it.  Groups stay below ``max_batch`` —
        full chunks dispatch at submit — so a forced dispatch always takes
        the whole group, tight member included.)"""
        name, _, t_pad = key
        q = self._pending[key]
        policy = self._policy_for(name)
        k = min(len(q), policy.max_batch)
        b_pad = policy.b_bucket(k)
        return (min(r.deadline for r in q)
                - self._est_service(name, b_pad, t_pad)
                - self.dispatch_margin)

    def next_deadline(self) -> float | None:
        """The earliest instant at which :meth:`poll` would force a partial
        dispatch — callers advance their clock to ``min(next arrival,
        next_deadline())``.  ``None`` when nothing pending has a finite
        trigger."""
        triggers = [self._trigger_time(k) for k, q in self._pending.items()
                    if q]
        finite = [t for t in triggers if t != math.inf]
        return min(finite) if finite else None

    def poll(self) -> list[tuple[int, RequestResult]]:
        """Dispatch every group that is full or past its deadline trigger at
        the current clock time; return all newly completed results.  When
        several groups are due at once, the weighted-fair pick goes first:
        lowest tenant virtual time, then earliest trigger — a flooding
        tenant's backlog queues behind the quieter tenants' due work."""
        while True:
            now = self.now()
            due = []
            for key, q in self._pending.items():
                if not q:
                    continue
                # submit() dispatches a group the moment it reaches
                # max_batch, so pending groups are always partial — only
                # deadlines fire here
                assert len(q) < self._policy_for(key[0]).max_batch
                trig = self._trigger_time(key)
                if trig <= now:
                    due.append((self._vtime.get(key[0], 0.0), trig, key))
            if not due:
                break
            _, _, key = min(due)
            self._dispatch(key, len(self._pending[key]), forced=True)
            # a simulated service period may have advanced the clock past
            # further triggers — loop until nothing is due *now*
        return self.collect()

    def flush(self, model: str | None = None
              ) -> list[tuple[int, RequestResult]]:
        """Dispatch everything still pending (shutdown / end of trace /
        hot-swap drain when ``model`` names one tenant) and return all
        remaining completed results."""
        for key in sorted(self._pending):
            if model is not None and key[0] != model:
                continue
            q = self._pending[key]
            if q:
                assert len(q) < self._policy_for(key[0]).max_batch  # see poll
                self._dispatch(key, len(q), forced=False)
        return self.collect()

    def collect(self) -> list[tuple[int, RequestResult]]:
        """Completed ``(rid, result)`` pairs since the last collection."""
        done, self._completed = self._completed, []
        return done

    # ------------------------------------------------------------ execution

    def _recover_mesh(self, err: DeviceLossError) -> None:
        """Elastic recovery at a dispatch boundary: shrink the serving mesh
        to the survivors (the replicated models need no state movement),
        forget the models' replicas on the lost devices, re-round every
        tenant's batch buckets to the new shard count (time buckets — and
        hence every queued request's ``t_pad`` — are preserved), and drop
        service-time estimates measured on the dead topology, tenant by
        tenant.  The serving twin of the train loop's elastic restart."""
        if self.mesh is None:
            raise err   # no mesh to shrink — a single-device loss is fatal
        old = self.mesh.size
        self.mesh = shrink_mesh(self.mesh, err.n_lost)   # raises if none left
        for e in (*self._entries.values(),
                  *map(self.registry.get, self.registry.names())):
            for m in (e.packed, e.clean):
                m.drop_devices(self.mesh.devices, self.mesh.size)
        names = list(self.registry.names())
        names += [n for n in self._policies if n not in names]
        for name in names:
            p = self._policy_for(name)
            self._policies[name] = BucketPolicy.for_mesh(
                self.mesh.size, batch_sizes=p.batch_sizes,
                time_steps=p.time_steps)
            self.clear_service_estimates(name)
        self.metrics.device_losses += 1
        if self.tracer is not None:
            self.tracer.anomaly("device_loss", t=self.now(),
                                n_lost=err.n_lost, mesh_from=old,
                                mesh_to=self.mesh.size)
        _log.warning("stream_server: lost %d device(s) mid-serving; "
                     "recovered %d -> %d-way mesh, default batch buckets "
                     "now %s (new engine shapes)", err.n_lost, old,
                     self.mesh.size, self.policy.batch_sizes)

    def _execute(self, packed, streams: list, plan: BatchPlan, *,
                 seq: int = 0, ts: float | None = None,
                 span_log: list | None = None):
        return execute_plan(
            packed, streams, plan,
            mesh=self.mesh, max_events=self.max_events,
            sn_capacity_rows=self.sn_capacity_rows,
            with_stats=self.with_stats, donate=self.donate,
            seq=seq, ts=ts, now=self.now, span_log=span_log)

    def _noise_probe(self, entry: ModelEntry, reqs, results, streams,
                     plan: BatchPlan) -> None:
        """Shadow-replay this dispatch through the tenant's clean
        (un-perturbed) model and count per-request prediction flips — the
        serving-time accuracy-under-noise signal.  Runs off the metrics
        clock (a measurement, not service work): no telemetry record, no
        EWMA update, no virtual-clock advance.  Each flip is recorded as a
        ``noise_disagreement`` anomaly on the (already completed) trace."""
        clean, _ = self._execute(entry.clean, streams, plan)
        m = self.metrics
        for req, res, ref in zip(reqs, results, clean):
            noisy_pred = int(res.out_spikes.sum(axis=0).argmax())
            clean_pred = int(ref.out_spikes.sum(axis=0).argmax())
            m.noise_probes += 1
            flipped = noisy_pred != clean_pred
            m.noise_disagreements += int(flipped)
            if flipped and self.tracer is not None:
                self.tracer.anomaly("noise_disagreement", t=self.now(),
                                    rid=req.rid, model=entry.name,
                                    noisy_pred=noisy_pred,
                                    clean_pred=clean_pred)

    def _slo_update(self) -> None:
        """Flip between extend-biased and shed mode on the windowed
        deadline-miss rate (see :class:`SLOPolicy`)."""
        if self.slo is None or len(self._slo_misses) < self.slo.min_samples:
            return
        rate = sum(self._slo_misses) / len(self._slo_misses)
        m = self.metrics
        if not m.slo_shedding and rate > self.slo.target_miss_rate:
            m.slo_shedding = True
            m.slo_switches += 1
            self.backpressure, self.overlong = "shed_oldest", "reject"
            _log.warning("stream_server: SLO breach (miss rate %.3f > "
                         "%.3f over %d reqs) — shedding", rate,
                         self.slo.target_miss_rate, len(self._slo_misses))
        elif m.slo_shedding and \
                rate < self.slo.restore_factor * self.slo.target_miss_rate:
            m.slo_shedding = False
            m.slo_switches += 1
            self.backpressure, self.overlong = self._slo_base
            _log.warning("stream_server: SLO recovered (miss rate %.3f) — "
                         "restoring backpressure=%s overlong=%s", rate,
                         *self._slo_base)

    def _dispatch(self, key: tuple[str, int, int], k: int,
                  forced: bool) -> None:
        name, gen, t_pad = key
        entry = self._entry_for((name, gen))
        q = self._pending[key]
        reqs = [q.popleft() for _ in range(k)]
        self._n_pending -= k
        self._n_pending_by[name] -= k
        streams = [r.stream for r in reqs]
        dispatch_t = self.now()
        tr = self.tracer
        # device loss surfaces at the dispatch boundary (from the chaos
        # hook here; from the runtime's watchdog in production); recovery
        # shrinks the mesh and retries the same requests — requests are
        # only lost to explicit shedding, never to hardware loss.  Without
        # a mesh the DeviceLossError propagates.
        while True:
            b_pad = self._policy_for(name).b_bucket(k)
            plan = BatchPlan(indices=tuple(range(k)), b_pad=b_pad,
                             t_pad=t_pad)
            span_log = [] if tr is not None else None
            try:
                if self.chaos_hook is not None:
                    self.chaos_hook(self.metrics.dispatches)
                results, record = self._execute(
                    entry.packed, streams, plan,
                    seq=self.metrics.dispatches, ts=dispatch_t,
                    span_log=span_log)
                break
            except DeviceLossError as e:
                self._recover_mesh(e)
        self.telemetry.append(record)
        ekey = (name, b_pad, t_pad)
        prev = self._ewma.get(ekey)
        self._ewma[ekey] = record["seconds"] if prev is None else \
            _EWMA_ALPHA * record["seconds"] + (1 - _EWMA_ALPHA) * prev
        service = (float(self.service_model(b_pad, t_pad))
                   if self.service_model is not None
                   else float(record["seconds"]))
        if self.service_model is not None and hasattr(self.clock, "advance"):
            self.clock.advance(service)
        # weighted-fair accounting: this tenant consumed `service` seconds
        # of the shared executor at share `weight`
        v = self._vtime.get(name, self._vglobal) + service / entry.weight
        self._vtime[name] = v
        self._vglobal = v
        end_t = self.now()
        m = self.metrics
        mm = m.model(name)
        m.dispatches += 1
        mm.dispatches += 1
        m.forced_dispatches += int(forced)
        m.fill.append(k / b_pad)
        m.queue_depth = self._n_pending
        if tr is not None:
            # dispatch-level attrs shared by every member trace: the
            # deterministic slice of the telemetry record (``seconds`` is
            # wall-measured and would break byte-identical replays), the
            # scheduler's *why* (deadline-forced vs full bucket), and the
            # per-layer hardware roll-up sampled from the engine results.
            det = {kk: record[kk] for kk in
                   ("seq", "b_pad", "t_pad", "n_requests", "events",
                    "out_spikes")}
            det.update(model=name, generation=gen)
            why = "deadline" if forced else "full_bucket"
            grp_deadline = min(r.deadline for r in reqs)
            hw_layers: list[dict] = []
            if results and results[0].stats:
                for li in range(len(results[0].stats)):
                    hw_layers.append({
                        "layer": li,
                        "events": sum(int(r.stats[li].events.sum())
                                      for r in results),
                        "engine_ops": sum(int(r.stats[li].engine_ops.sum())
                                          for r in results),
                        "cycles": sum(int(r.stats[li].cycles.sum())
                                      for r in results),
                        "rows_touched": sum(
                            int(r.stats[li].rows_touched.sum())
                            for r in results),
                        "util_mean": float(np.mean(
                            [float(np.mean(r.util[li])) for r in results])),
                    })
                if results[0].spec is not None:
                    ereps = [r.energy() for r in results]
                    det["energy_j"] = float(sum(
                        er.dynamic_j + er.static_j for er in ereps))
                    det["tops_per_w"] = float(np.mean(
                        [er.tops_per_w for er in ereps]))
            tr.observe("service_s", end_t - dispatch_t)
            tr.observe("fill", k / b_pad)
        for req, res in zip(reqs, results):
            self._completed.append((req.rid, res))
            if self.on_completion is not None:
                self.on_completion(req.rid, res)
            m.completed += 1
            mm.completed += 1
            m.observe_ttfd(dispatch_t - req.arrival_t)
            m.observe_latency(end_t - req.arrival_t)
            mm.observe_latency(end_t - req.arrival_t)
            missed = end_t > req.deadline
            m.deadline_misses += int(missed)
            mm.deadline_misses += int(missed)
            self._slo_misses.append(missed)
            if tr is not None:
                tr.span(req.rid, "queue", req.arrival_t, dispatch_t)
                sched = {"why": why, "n_requests": k}
                if grp_deadline != math.inf:
                    sched["group_deadline"] = float(grp_deadline)
                tr.span(req.rid, "schedule", dispatch_t, dispatch_t, **sched)
                # lifecycle order: pad -> dispatch -> slice (the pad/slice
                # micro-spans come off execute_plan's span_log)
                for kind, s0, s1, attrs in span_log:
                    if kind == "pad":
                        tr.span(req.rid, kind, s0, s1, **attrs)
                tr.span(req.rid, "dispatch", dispatch_t, end_t, **det)
                for kind, s0, s1, attrs in span_log:
                    if kind != "pad":
                        tr.span(req.rid, kind, s0, s1, **attrs)
                for hw in hw_layers:
                    tr.span(req.rid, "hw", dispatch_t, end_t, **hw)
                tr.span(req.rid, "complete", end_t, end_t,
                        latency_s=end_t - req.arrival_t, missed=missed)
                if missed:
                    tr.anomaly("deadline_miss", t=end_t, rid=req.rid,
                               deadline=float(req.deadline),
                               late_s=end_t - req.deadline, model=name)
                tr.observe("ttfd_s", dispatch_t - req.arrival_t)
                tr.observe("latency_s", end_t - req.arrival_t)
                tr.complete(req.rid, end_t)
        if (entry.noise is not None and self.noise_probe_every
                and mm.dispatches % self.noise_probe_every == 0):
            self._noise_probe(entry, reqs, results, streams, plan)
        if not q:
            # GC: a drained group of a superseded generation releases its
            # pin on the old weights
            del self._pending[key]
            if gen != self.registry.get(name).generation and not any(
                    k[0] == name and k[1] == gen and self._pending[k]
                    for k in self._pending):
                self._entries.pop((name, gen), None)
        self._slo_update()


# -------------------------------------------------------------- trace replay

def serve_trace(server: StreamServer, trace, *, control=()):
    """Replay a time-stamped arrival trace through a :class:`StreamServer`
    on a :class:`VirtualClock`, firing deadline-triggered dispatches at the
    exact instants they become due between arrivals.

    ``trace``: iterable of ``(arrival_t, stream)``, ``(arrival_t, stream,
    deadline)``, or ``(arrival_t, stream, deadline, model)`` tuples,
    non-decreasing in ``arrival_t`` (absolute deadline; ``None`` = the
    server's ``default_slack``; ``model`` ``None`` = the default route).
    ``control`` is an optional list of ``(t, fn)`` pairs — ``fn(server)``
    runs at simulated time ``t``, interleaved with arrivals in time order;
    this is how a trace replays a mid-soak hot-swap
    (``lambda s: s.swap(...)``) deterministically.  When a simulated
    service period (``service_model``) runs past the next arrival, that
    request is admitted as soon as the executor frees up — back-dated to
    its true arrival for latency accounting, exactly like a
    single-threaded server draining a socket between engine calls.
    Remaining requests are flushed after the last arrival.  Returns
    ``(results, rids)``: a dict ``rid -> RequestResult`` and the
    per-trace-entry rid (``None`` where admission rejected the request).
    """
    clock = server.clock
    assert isinstance(clock, VirtualClock), \
        "serve_trace replays simulated time; build the server with a " \
        "VirtualClock (a WallClock server is driven by real arrivals instead)"
    results: dict[int, RequestResult] = {}
    rids: list[int | None] = []

    def drain(pairs):
        for rid, res in pairs:
            results[rid] = res

    def advance_to(t):
        """Run the clock forward to ``t``, firing deadline triggers at the
        exact instants they become due on the way."""
        while True:
            nd = server.next_deadline()
            if nd is None or nd > t:
                break
            clock.advance(max(0.0, nd - clock.now()))
            fired = server.poll()
            drain(fired)
            if not fired:
                break   # estimate moved the trigger; re-check next event
        clock.advance(max(0.0, t - clock.now()))

    control = sorted(control, key=lambda cf: cf[0])
    ci = 0
    prev_t = -math.inf
    for item in trace:
        if len(item) == 2:
            t_a, stream, deadline, model = (*item, None, None)
        elif len(item) == 3:
            t_a, stream, deadline, model = (*item, None)
        else:
            t_a, stream, deadline, model = item
        assert t_a >= prev_t, \
            f"trace arrivals must be non-decreasing ({t_a} < {prev_t})"
        prev_t = t_a
        while ci < len(control) and control[ci][0] <= t_a:
            t_c, fn = control[ci]
            ci += 1
            advance_to(t_c)
            fn(server)
            drain(server.collect())     # e.g. results drained by a hot-swap
        advance_to(t_a)
        rids.append(server.submit(stream, deadline=deadline, model=model,
                                  arrival_t=min(t_a, clock.now())))
        drain(server.poll())
    for t_c, fn in control[ci:]:
        advance_to(t_c)
        fn(server)
        drain(server.collect())
    drain(server.flush())
    return results, rids
