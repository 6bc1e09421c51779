"""Continuous-batching front end: variable-length event streams -> buckets.

Production DVS traffic is a stream of requests, each its own spike train
``[T_i, n_in]`` with its own duration.  A :class:`BucketPolicy` fixes a
small grid of padded ``(B, T)`` shapes, so the engine sees a bounded set of
shapes however varied the traffic; the
scheduler groups pending requests by time bucket, chunks them into batch
buckets, zero-pads, runs, and slices each request's exact result back out.

Why padding is free (bit-wise): the LIF scan is causal, so zero-current
steps appended after ``T_i`` cannot change steps ``< T_i``; zero batch rows
are independent samples that get discarded.  Every per-request result —
output spikes, per-step DispatchStats, utilization, overflow, energy — is
therefore bit-identical to running that request alone at its native shape,
and hence to the numpy oracle (tested, ``tests/test_torch_serving.py``).

At most ``policy.n_buckets`` distinct shapes ever reach the engine,
verified through the ``trace_count()`` probe.  Without a mesh the engine
runs on the device of the packed model; ``mesh=`` routes every engine call
through :func:`~repro_torch.engine.sharded_run.run_sharded`, and the
policy's batch buckets are then rounded to multiples of the mesh's size
(:meth:`BucketPolicy.covering`, :meth:`BucketPolicy.for_mesh`) so that
every bucket splits evenly.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from repro_torch.core.energy import FRAME_CYCLES, EnergyReport, energy_model
from repro_torch.core.memories import DispatchStats
from repro_torch.device import canonical_device, resolve_device
from repro_torch.engine import batched_run as br
from repro_torch.engine.sharded_run import run_sharded
from repro_torch.engine.tracing import span

_log = logging.getLogger(__name__)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class OverlongRequestError(ValueError):
    """Raised at admission when requests exceed the policy's largest time
    bucket and auto-extension is off.  ``requests`` lists ``(index,
    length)`` per offending request so callers can reject those requests
    individually instead of failing the whole batch plan."""

    def __init__(self, requests: list[tuple[int, int]], t_max: int):
        self.requests = list(requests)
        self.t_max = t_max
        detail = ", ".join(f"request {i}: {t} steps" for i, t in self.requests)
        super().__init__(
            f"{len(self.requests)} request(s) exceed the largest time bucket "
            f"({t_max}): {detail} — pass overlong='extend' to grow the grid, "
            f"or reject these requests at admission")


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The fixed ``(B, T)`` shape grid the engine is allowed to see.

    ``batch_sizes`` and ``time_steps`` are ascending; a request of length
    ``T_i`` lands in the smallest time bucket ``>= T_i``, and a chunk of
    ``k`` requests pads to the smallest batch bucket ``>= k`` (chunks are
    capped at ``max_batch``).  ``n_buckets`` bounds the engine's shapes.
    """

    batch_sizes: tuple[int, ...] = (1, 4, 16)
    time_steps: tuple[int, ...] = (8, 16, 32)

    def __post_init__(self):
        for name in ("batch_sizes", "time_steps"):
            v = getattr(self, name)
            if not (v and all(x > 0 for x in v)
                    and list(v) == sorted(set(v))):
                raise ValueError(f"{name} must be ascending unique positive "
                                 f"ints, got {v}")

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    @property
    def n_buckets(self) -> int:
        return len(self.batch_sizes) * len(self.time_steps)

    def t_bucket(self, t: int) -> int:
        for tb in self.time_steps:
            if t <= tb:
                return tb
        raise ValueError(
            f"request of {t} steps exceeds the largest time bucket "
            f"{self.time_steps[-1]}; extend the policy "
            f"(BucketPolicy.covering picks buckets from observed lengths)")

    def fits(self, t: int) -> bool:
        """Whether a ``t``-step request lands in the grid at all — the
        admission check that keeps :meth:`t_bucket` from failing mid-plan."""
        return 0 < t <= self.time_steps[-1]

    def with_time_bucket(self, t: int) -> "BucketPolicy":
        """The policy extended to cover a ``t``-step request: the largest
        bucket doubles until it covers ``t`` (geometric growth, so a stream
        of ever-longer requests costs O(log T) new traces, not one each).
        Returns ``self`` unchanged when ``t`` already fits."""
        if t <= 0:
            raise ValueError(f"cannot extend the grid to a {t}-step request")
        if self.fits(t):
            return self
        tb = self.time_steps[-1]
        while tb < t:
            tb *= 2
        return dataclasses.replace(self, time_steps=self.time_steps + (tb,))

    def b_bucket(self, b: int) -> int:
        if not 0 < b <= self.max_batch:
            raise ValueError(f"batch of {b} outside (0, {self.max_batch}]")
        return next(bb for bb in self.batch_sizes if b <= bb)

    @classmethod
    def covering(cls, lengths, *, n_shards: int = 1,
                 max_batch: int = 16) -> "BucketPolicy":
        """A policy whose time buckets are the powers of two covering the
        observed request ``lengths`` and whose batch buckets are powers of
        four up to ``max_batch``, each rounded up to a multiple of
        ``n_shards`` (so every bucket splits evenly on the serving mesh)."""
        t_max = max(int(t) for t in lengths)
        steps, t = [], 1
        while t < t_max:
            t *= 2
        for tb in (max(t // 4, 1), max(t // 2, 1), t):
            if tb not in steps:
                steps.append(tb)
        bs, b = [], 1
        while b < max_batch:
            bs.append(_round_up(b, n_shards))
            b *= 4
        bs.append(_round_up(max_batch, n_shards))
        return cls(batch_sizes=tuple(sorted(set(bs))),
                   time_steps=tuple(sorted(set(steps))))

    @classmethod
    def for_mesh(cls, n_shards: int,
                 batch_sizes: tuple[int, ...] = (1, 4, 16),
                 time_steps: tuple[int, ...] = (8, 16, 32)) -> "BucketPolicy":
        """Every batch bucket rounded up to a multiple of the mesh's size,
        so that ``run_sharded`` always gets a divisible batch."""
        return cls(batch_sizes=tuple(sorted({_round_up(b, n_shards)
                                             for b in batch_sizes})),
                   time_steps=tuple(time_steps))


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One engine call: which requests ride it and the padded shape."""

    indices: tuple[int, ...]
    b_pad: int
    t_pad: int


def plan_batches(lengths, policy: BucketPolicy) -> list[BatchPlan]:
    """Deterministic scheduler: group requests by time bucket (arrival order
    preserved within a bucket), chunk each group at ``max_batch``, pad each
    chunk's batch to its batch bucket.  Every index appears exactly once."""
    groups: dict[int, list[int]] = {}
    for i, t in enumerate(lengths):
        if t <= 0:
            raise ValueError(f"request {i} has {t} time steps")
        groups.setdefault(policy.t_bucket(int(t)), []).append(i)
    plans = []
    for t_pad in sorted(groups):
        idxs = groups[t_pad]
        for lo in range(0, len(idxs), policy.max_batch):
            chunk = idxs[lo:lo + policy.max_batch]
            plans.append(BatchPlan(indices=tuple(chunk),
                                   b_pad=policy.b_bucket(len(chunk)),
                                   t_pad=t_pad))
    return plans


@dataclasses.dataclass
class RequestResult:
    """One request's slice of a bucketed run — the same surfaces as the
    oracle :class:`repro_torch.core.accelerator.RunResult`, bit-exact."""

    out_spikes: np.ndarray                      # [T_i, n_out]
    stats: list[DispatchStats]                  # per layer (empty w/o stats)
    util: list[np.ndarray]                      # [T_i] per layer
    overflow: list[np.ndarray]                  # [T_i] per layer
    spec: object = None
    per_layer_bits: "list[int] | None" = None   # stored word widths (energy)

    def energy(self, frame_cycles: int | None = FRAME_CYCLES) -> EnergyReport:
        """Same signature as :func:`repro_torch.core.energy.energy_model`: the
        frame period defaults to the calibrated ``FRAME_CYCLES`` constant,
        ``None`` means throughput mode (no idle between frames).
        Mixed-precision models price the C2C MAC energy at each layer's
        stored word width."""
        if self.spec is None or not self.stats:
            raise ValueError("energy needs with_stats=True and an "
                             "AcceleratorSpec")
        return energy_model(self.spec, self.stats, frame_cycles=frame_cycles,
                            per_core_bits=self.per_layer_bits)


def _slice_request(res: "br.BatchedRunResult", row: int, t: int,
                   with_stats: bool) -> RequestResult:
    out = res.out_spikes[row, :t]
    if not with_stats:
        return RequestResult(out_spikes=out, stats=[], util=[], overflow=[],
                             spec=res.spec, per_layer_bits=res.per_layer_bits)
    stats = []
    for bs in res.per_layer_stats:
        full = bs.sample(row)
        stats.append(DispatchStats(
            cycles=full.cycles[:t], rows_touched=full.rows_touched[:t],
            engine_ops=full.engine_ops[:t], events=full.events[:t],
            sn_bytes_touched=full.sn_bytes_touched[:t],
            # padded steps are silent -> they contribute 0 to the peak
            mem_e_peak=full.mem_e_peak))
    return RequestResult(
        out_spikes=out, stats=stats,
        util=[u[row, :t] for u in res.per_layer_util],
        overflow=[o[row, :t] for o in res.overflow],
        spec=res.spec, per_layer_bits=res.per_layer_bits)


# The per-engine-call telemetry record schema, the reference's tuple.
# ``seq`` is a monotonic per-producer dispatch ordinal and ``ts`` the
# producer's clock at dispatch (the StreamServer passes its pluggable
# clock's now, so VirtualClock replays stamp deterministic timestamps);
# ``seconds`` is wall-measured engine time.
TELEMETRY_KEYS = ("seq", "ts", "b_pad", "t_pad", "n_requests", "events",
                  "out_spikes", "seconds")


def execute_plan(packed: "br.PackedModel", streams, plan: BatchPlan, *,
                 mesh=None, max_events: int | None = None,
                 sn_capacity_rows: int | None = None,
                 with_stats: bool = True,
                 donate: bool | None = None,
                 seq: int = 0, ts: float | None = None,
                 now=None, span_log: list | None = None
                 ) -> tuple[list[RequestResult], dict]:
    """One engine call: stage ``plan``'s requests, zero-padded, as the
    ``> 0`` mask of the plan's ``(b_pad, t_pad)`` bucket in the model's
    staging buffer for it (:func:`~repro_torch.engine.batched_run
    .staging`), run on the packed model's device, and slice each
    request's bit-exact result back out; ``mesh`` runs the call sharded
    over it (:func:`~repro_torch.engine.sharded_run.run_sharded`).

    The single execution path shared by :func:`run_bucketed` and the
    always-on :class:`~repro_torch.engine.stream_server.StreamServer`.
    Returns the per-request results (aligned with ``plan.indices``) and one
    ``TELEMETRY_KEYS`` record; ``seconds`` ends after the results are back
    on the host, so it covers the device work.  ``donate`` refills the
    bucket's input buffer (see :func:`~repro_torch.engine.batched_run
    .run_batched`).

    ``seq``/``ts`` stamp the record.  ``span_log``, if a list, receives
    ``(kind, t0, t1, attrs)`` tuples for the ``pad`` and ``slice`` stages
    measured on ``now`` (the caller's clock; defaults to
    ``time.monotonic``).  Under a VirtualClock these are zero-width point
    events, so traces stay replay-deterministic.  The call and its stages
    are stage spans (:func:`~repro_torch.engine.tracing.span`):
    ``serving.execute`` around ``serving.pad``, the engine's own,
    ``serving.record`` and ``serving.slice``; the two reads of ``now``
    that bound ``pad`` and ``slice`` in ``span_log`` are the reads of
    those spans, taken inside their profiler ranges, so each stage is
    timed once.
    """
    clock = None                # pad and slice read a clock for span_log
    if span_log is not None:
        clock = time.monotonic if now is None else now
    with span("serving.execute"):
        with span("serving.pad", clock) as pad:
            padded = br.staging(packed, plan.b_pad, plan.t_pad).fill(
                [streams[i] for i in plan.indices])
        if span_log is not None:
            span_log.append(("pad", pad.t0, pad.t1,
                             {"b_pad": plan.b_pad, "t_pad": plan.t_pad}))
        t0 = time.perf_counter()
        if mesh is None:
            res = br.run_batched(packed, padded, max_events=max_events,
                                 sn_capacity_rows=sn_capacity_rows,
                                 with_stats=with_stats, donate=donate)
        else:
            res = run_sharded(packed, padded, mesh=mesh,
                              max_events=max_events,
                              sn_capacity_rows=sn_capacity_rows,
                              with_stats=with_stats, donate=donate)
        dt = time.perf_counter() - t0
        with span("serving.record"):
            record = {
                "seq": int(seq),
                "ts": float(time.monotonic() if ts is None else ts),
                "b_pad": plan.b_pad, "t_pad": plan.t_pad,
                "n_requests": len(plan.indices),
                "events": int(sum(
                    np.count_nonzero(padded[row, :streams[i].shape[0]])
                    for row, i in enumerate(plan.indices))),
                "out_spikes": int(sum(
                    res.out_spikes[row, :streams[i].shape[0]].sum()
                    for row, i in enumerate(plan.indices))),
                "seconds": dt}
        with span("serving.slice", clock) as sl:
            results = [_slice_request(res, row, streams[i].shape[0],
                                      with_stats)
                       for row, i in enumerate(plan.indices)]
        if span_log is not None:
            span_log.append(("slice", sl.t0, sl.t1,
                             {"n_requests": len(plan.indices)}))
    return results, record


def run_bucketed(model, streams, *, policy: BucketPolicy | None = None,
                 mesh=None, max_events: int | None = None,
                 sn_capacity_rows: int | None = None,
                 with_stats: bool = True,
                 telemetry: list | None = None,
                 overlong: str = "error",
                 donate: bool | None = None,
                 noise=None, noise_key=0,
                 device=None) -> list[RequestResult]:
    """Serve a list of variable-length spike streams (``[T_i, n_in]`` each)
    through the bucketed engine; results come back in request order.

    A :class:`~repro_torch.engine.batched_run.PackedModel` serves on its own
    device (replicated onto the mesh's devices under ``mesh``); a mapped
    model is packed onto ``device`` first (default the mesh's first device,
    else the card — with no card, pass ``device="cpu"``).

    ``policy`` defaults to :meth:`BucketPolicy.covering` over the observed
    lengths (rounded to the mesh's size when ``mesh`` is given).  ``mesh``
    routes every engine call through
    :func:`~repro_torch.engine.sharded_run.run_sharded`; ``None`` serves on
    the model's device.  ``telemetry``, if a list, receives one dict per
    engine call (padded shape, request count, events served, wall
    seconds).

    ``overlong`` governs requests longer than the policy's largest time
    bucket, checked at admission (before any engine work): ``"error"``
    raises :class:`OverlongRequestError` naming every offending request;
    ``"extend"`` grows the grid geometrically (new shapes, logged) so the
    rest of the batch is unaffected.

    ``noise`` (an :class:`repro_torch.core.noise.AnalogNoise`) serves the
    batch through one deterministic noisy device instance:
    :func:`repro_torch.core.noise.perturb_packed` applies the C2C-ladder
    gain error to the effective weights under ``noise_key`` (an int seed
    or a ``torch.Generator``) before any dispatch.  The same ``(noise,
    noise_key)`` is bit-reproducible, on the card and on the CPU alike.
    """
    if overlong not in ("error", "extend"):
        raise ValueError(f"overlong must be 'error' or 'extend', "
                         f"got {overlong!r}")
    if isinstance(model, br.PackedModel):
        packed = model
        if (device is not None
                and canonical_device(resolve_device(device)) != packed.device):
            raise ValueError(f"model is packed on {packed.device}, "
                             f"not {device}")
    else:
        if device is None:
            device = mesh.devices[0] if mesh is not None else "cuda"
        packed = model.pack(device=device)
    if noise is not None:
        from repro_torch.core.noise import as_noise_key, perturb_packed
        packed = perturb_packed(as_noise_key(noise_key), packed, noise)
    streams = [np.asarray(s, dtype=np.float32) for s in streams]
    for i, s in enumerate(streams):
        if s.ndim != 2 or s.shape[1] != packed.n_in or s.shape[0] == 0:
            raise ValueError(f"request {i}: expected [T > 0, {packed.n_in}], "
                             f"got {s.shape}")
    if not streams:
        return []
    lengths = [s.shape[0] for s in streams]
    if policy is None:
        policy = BucketPolicy.covering(
            lengths, n_shards=mesh.size if mesh is not None else 1)
    over = [(i, t) for i, t in enumerate(lengths) if not policy.fits(t)]
    if over:
        if overlong == "error":
            raise OverlongRequestError(over, policy.time_steps[-1])
        for _, t in over:
            policy = policy.with_time_bucket(t)
        _log.warning("run_bucketed: %d over-long request(s) extended the "
                     "bucket grid to time_steps=%s (new shapes)",
                     len(over), policy.time_steps)
    results: list[RequestResult | None] = [None] * len(streams)
    for seq, plan in enumerate(plan_batches(lengths, policy)):
        reqs, record = execute_plan(packed, streams, plan, mesh=mesh,
                                    max_events=max_events,
                                    sn_capacity_rows=sn_capacity_rows,
                                    with_stats=with_stats, donate=donate,
                                    seq=seq)
        if telemetry is not None:
            telemetry.append(record)
        for row, i in enumerate(plan.indices):
            results[i] = reqs[row]
    return results  # type: ignore[return-value]
