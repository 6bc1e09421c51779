"""Chaos scenarios for the always-on serving loop, replayable bit-for-bit.

MENAGE's pitch is an always-on edge accelerator; an always-on server earns
that claim by surviving the failure modes the paper's substrate implies, not
just a Poisson replay.  This module is the port's scenario layer, the
reference's scenarios unchanged (``tests/test_torch_chaos.py``):

  * :func:`synth_arrival_trace` — the arrival processes, numpy only, so
    the same seed gives the reference's trace exactly.  Beyond the
    ``poisson`` baseline and the ``bursty`` batch-formation stressor, it
    adds ``diurnal`` (sinusoidally-modulated offered load — the day/night
    swing an edge deployment actually sees) and ``adversarial`` (alternating
    flood/famine phases with tight deadlines on the floods and a lone
    long request per famine — engineered to leave partial buckets behind
    and force deadline-triggered dispatches at worst-case moments).
  * :class:`ChaosScenario` + :data:`SCENARIOS` — named, fully-parameterized
    failure scripts: device loss mid-serving (via :func:`make_chaos_hook`
    raising :class:`~repro_torch.engine.sharded_run.DeviceLossError` at
    scripted dispatch ordinals; these need a mesh and are refused on one
    device), serving-time analog noise
    (:class:`~repro_torch.core.noise.AnalogNoise` through the server's
    shadow probes), SLO-driven shed-vs-extend switching
    (:class:`~repro_torch.engine.stream_server.SLOPolicy`), and the
    combined ``blackout`` scenario that fires all of them in one run.
  * :func:`run_scenario` — one scenario end-to-end on a
    :class:`~repro_torch.engine.stream_server.VirtualClock` with a constant
    simulated service time: **every** number in the returned metrics is
    derived from counters and simulated time, so a scenario replays
    deterministically, with zero wall-clock flakiness.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.noise import AnalogNoise, as_noise_key, perturb_packed
from repro_torch.engine import batched_run as br
from repro_torch.engine.registry import ModelRegistry
from repro_torch.engine.serving import BucketPolicy
from repro_torch.engine.sharded_run import DeviceLossError
from repro_torch.engine.stream_server import (SLOPolicy, StreamServer,
                                              VirtualClock, serve_trace)


# ----------------------------------------------------------- arrival synth

def synth_arrival_trace(n: int, n_in: int, *, mode: str = "poisson",
                        rate: float = 200.0, burst: int = 6,
                        t_lo: int = 4, t_hi: int = 30,
                        spike_p: float = 0.15, slack: float = 0.25,
                        period: float = 1.0, depth: float = 0.9,
                        seed: int = 0) -> list[tuple[float, np.ndarray, float]]:
    """A time-stamped arrival process for the async server: ``n`` requests
    as ``(arrival_t, stream, deadline)`` tuples, non-decreasing in time.

    ``poisson`` draws i.i.d. exponential interarrivals at ``rate`` req/s —
    the memoryless baseline.  ``bursty`` emits back-to-back bursts of
    ``burst`` simultaneous requests with exponential gaps between bursts at
    the *same* mean offered load — the adversarial case for batch
    formation, where a deadline-blind scheduler would sit on partial
    buckets.  ``diurnal`` modulates the instantaneous rate sinusoidally
    (``rate * (1 + depth * sin(2*pi*t / period))``, floored at 5% of
    ``rate``): sustained peaks that probe queue growth and troughs that
    probe deadline-forced partial dispatch.  ``adversarial`` alternates
    flood phases — ``burst - 1`` simultaneous *short* requests with
    quarter ``slack`` — with famine phases of a single long request after
    a dead gap: floods race tight deadlines, famines strand lone requests
    in otherwise-empty buckets, and the length split scatters the queue
    across time buckets.  Deadlines are ``arrival + slack`` seconds except
    where noted."""
    rng = np.random.default_rng(seed)
    slacks: list[float] | None = None
    if mode == "poisson":
        lengths = rng.integers(t_lo, t_hi + 1, size=n)
        times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    elif mode == "bursty":
        lengths = rng.integers(t_lo, t_hi + 1, size=n)
        n_bursts = -(-n // burst)
        starts = np.cumsum(rng.exponential(burst / rate, size=n_bursts))
        times = np.repeat(starts, burst)[:n]
    elif mode == "diurnal":
        lengths = rng.integers(t_lo, t_hi + 1, size=n)
        ts, t = [], 0.0
        for _ in range(n):
            r = max(rate * (1.0 + depth * math.sin(2 * math.pi * t / period)),
                    0.05 * rate)
            t += float(rng.exponential(1.0 / r))
            ts.append(t)
        times = np.asarray(ts)
    elif mode == "adversarial":
        ts, ls, sl, t = [], [], [], 0.0
        while len(ts) < n:
            for _ in range(max(burst - 1, 1)):          # flood: short + tight
                if len(ts) >= n:
                    break
                ts.append(t)
                ls.append(t_lo)
                sl.append(slack * 0.25)
            t += 4.0 * burst / rate                     # dead gap
            if len(ts) < n:                             # famine: lone + long
                ts.append(t)
                ls.append(t_hi)
                sl.append(slack)
            t += float(rng.exponential(burst / rate))
        times, lengths, slacks = np.asarray(ts), np.asarray(ls), sl
    else:
        raise ValueError(f"unknown arrival mode {mode!r} "
                         "(poisson|bursty|diurnal|adversarial)")
    if slacks is None:
        slacks = [slack] * n
    return [(float(t_a),
             (rng.random((int(t_len), n_in)) < spike_p).astype(np.float32),
             float(t_a) + s)
            for t_a, t_len, s in zip(times, lengths, slacks)]


ARRIVAL_MODES = ("poisson", "bursty", "diurnal", "adversarial")


# ------------------------------------------------------------- chaos hooks

def make_chaos_hook(lose_devices):
    """A dispatch-boundary failure injector: ``lose_devices`` is a sequence
    of ``(dispatch_ordinal, n_lost)`` pairs; the hook raises
    :class:`DeviceLossError` the first time the server reaches each
    scripted ordinal (and never again for that ordinal, so the recovery
    retry proceeds)."""
    pending = dict(lose_devices)

    def hook(dispatch_ordinal: int) -> None:
        n = pending.pop(dispatch_ordinal, None)
        if n:
            raise DeviceLossError(
                n, f"chaos injection at dispatch {dispatch_ordinal}")

    return hook


# -------------------------------------------------------------- scenarios

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of a multi-tenant scenario: its own arrival process and
    deadline profile on the shared fabric.  ``seed_offset`` decorrelates
    the tenant's trace from its neighbours under the scenario seed;
    ``weight`` is its weighted-fair scheduling share."""

    name: str
    arrivals: str = "poisson"
    n_requests: int = 24
    rate: float = 200.0
    slack: float = 0.25
    t_lo: int = 3
    t_hi: int = 12
    weight: float = 1.0
    seed_offset: int = 0


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """One named failure script for the always-on server.  Every field is
    plain data, so a scenario is reproducible from its definition alone;
    ``needs_mesh`` marks scripts that only make sense with >= 2 devices
    (device loss on a 1-device mesh has nothing to recover onto)."""

    name: str
    description: str
    arrivals: str = "poisson"
    n_requests: int = 32
    rate: float = 200.0
    slack: float = 0.25
    t_lo: int = 3
    t_hi: int = 12
    noise_sigma: float = 0.0            # serving-time C2C gain error
    noise_probe_every: int = 1          # shadow-probe cadence (dispatches)
    lose_devices: tuple[tuple[int, int], ...] = ()  # (dispatch_idx, n_lost)
    slo: SLOPolicy | None = None
    backpressure: str = "reject"
    overlong: str = "extend"
    queue_capacity: int = 256
    service_s: float = 0.002            # simulated seconds per engine call
    seed: int = 0
    # multi-tenant scripts: each TenantSpec serves the scenario model as its
    # own registry entry (own bucket policy, own arrival process); an empty
    # tuple is the single-tenant fast path.  swap_tenant/swap_at script a
    # mid-soak hot-swap: at simulated time swap_at the named tenant's
    # weights are replaced by a deterministically perturbed instance
    # (swap_sigma C2C gain error on the base model) — same shapes,
    # different bits, fully reproducible from the scenario seed.
    tenants: tuple[TenantSpec, ...] = ()
    swap_tenant: str | None = None
    swap_at: float = 0.08               # simulated seconds into the soak
    swap_sigma: float = 0.2

    @property
    def needs_mesh(self) -> bool:
        return bool(self.lose_devices)


SCENARIOS: dict[str, ChaosScenario] = {s.name: s for s in (
    ChaosScenario(
        name="baseline",
        description="Poisson arrivals, no faults — the control run every "
                    "chaos metric is read against."),
    ChaosScenario(
        name="diurnal",
        description="Sinusoidally-modulated offered load: peak pressure on "
                    "the queue, trough pressure on deadline-forced partial "
                    "dispatch.",
        arrivals="diurnal", n_requests=48, rate=400.0, slack=0.1),
    ChaosScenario(
        name="adversarial",
        description="Flood/famine arrival pattern engineered against batch "
                    "formation: tight-deadline floods, stranded lone "
                    "requests, lengths scattered across time buckets.",
        arrivals="adversarial", n_requests=48, rate=300.0, slack=0.2),
    ChaosScenario(
        name="device_loss",
        description="Lose a device at the 2nd dispatch mid-serving; the "
                    "server must recover onto the shrunken mesh with zero "
                    "requests lost.",
        n_requests=32, lose_devices=((1, 1),)),
    ChaosScenario(
        name="analog_noise",
        description="Serve through one noisy device instance (5% C2C gain "
                    "error) with a shadow probe every dispatch: "
                    "accuracy-under-noise lands in the metrics.",
        noise_sigma=0.05, noise_probe_every=1),
    ChaosScenario(
        name="slo_shed",
        description="Offered load beyond capacity with tight deadlines and "
                    "an SLO controller: the server must flip to shedding "
                    "when the windowed miss rate breaches target, and flip "
                    "back once load drains.",
        arrivals="bursty", n_requests=64, rate=2000.0, slack=0.02,
        service_s=0.008, queue_capacity=8,
        slo=SLOPolicy(target_miss_rate=0.2, window=16, min_samples=4)),
    ChaosScenario(
        name="blackout",
        description="The acceptance combo: adversarial arrivals + device "
                    "loss mid-serving + serving-time analog noise + SLO "
                    "shedding, all in one run — the server must end the "
                    "trace recovered, with deadline-miss and "
                    "accuracy-under-noise metrics populated.",
        arrivals="adversarial", n_requests=48, rate=300.0, slack=0.2,
        noise_sigma=0.05, noise_probe_every=2, lose_devices=((2, 1),),
        slo=SLOPolicy(target_miss_rate=0.5, window=16, min_samples=8)),
    ChaosScenario(
        name="multi_tenant",
        description="Two tenants share one fabric: a steady Poisson tenant "
                    "with real deadlines next to an adversarial flood "
                    "tenant, plus a mid-soak hot-swap of the steady "
                    "tenant's weights.  Weighted-fair scheduling must keep "
                    "the flood from starving the steady tenant's deadlines, "
                    "and the swap must drain on the old weights with zero "
                    "requests lost.",
        tenants=(TenantSpec(name="steady", arrivals="poisson",
                            n_requests=24, rate=150.0, slack=0.25,
                            seed_offset=1),
                 TenantSpec(name="bursty", arrivals="adversarial",
                            n_requests=32, rate=400.0, slack=0.2,
                            seed_offset=2)),
        swap_tenant="steady", swap_at=0.08),
)}


def run_scenario(model, scenario: ChaosScenario, *,
                 policy: BucketPolicy | None = None, recorder=None):
    """Replay one scenario deterministically on a :class:`VirtualClock`.

    The server's service times come from the scenario's constant
    ``service_s`` (grounding the discrete-event simulation), arrivals from
    :func:`synth_arrival_trace` under the scenario seed, and faults from
    the scenario script — so two runs of the same scenario produce
    bit-identical results and metrics (tested).  Returns ``(results, rids,
    metrics)`` where ``metrics`` is the ``ServerMetrics`` snapshot plus
    scenario bookkeeping (name, mesh sizes — 1 and 1 on one device —,
    makespan, admitted-served accounting).  A mapped model is packed onto
    the card; pass a packed model to serve elsewhere.  Scenarios that
    script device loss need a mesh of at least 2 devices and raise
    ``ValueError`` here, as the reference refuses them without one.

    ``recorder`` (a :class:`~repro_torch.engine.tracing.FlightRecorder`) attaches
    the span tracer to the replay: every injected fault then lands as a
    typed anomaly and, because the replay runs on a VirtualClock, two
    replays of the same scenario produce byte-identical
    ``recorder.dump_json()``."""
    packed = model if isinstance(model, br.PackedModel) else model.pack()
    if scenario.needs_mesh:
        raise ValueError(
            f"scenario {scenario.name!r} scripts device loss — it needs a "
            f">= 2-device mesh, and serving here is single-device")
    if scenario.tenants:
        return _run_multi_tenant(packed, scenario, policy=policy,
                                 recorder=recorder)
    trace = synth_arrival_trace(
        scenario.n_requests, packed.n_in, mode=scenario.arrivals,
        rate=scenario.rate, slack=scenario.slack, t_lo=scenario.t_lo,
        t_hi=scenario.t_hi, seed=scenario.seed)
    if policy is None:
        policy = BucketPolicy.covering([s.shape[0] for _, s, _ in trace],
                                       max_batch=4)
    noise = (AnalogNoise(weight_sigma=scenario.noise_sigma)
             if scenario.noise_sigma > 0 else None)
    server = StreamServer(
        packed, policy=policy, clock=VirtualClock(),
        queue_capacity=scenario.queue_capacity,
        backpressure=scenario.backpressure, overlong=scenario.overlong,
        service_model=lambda b, t: scenario.service_s,
        noise=noise, noise_key=scenario.seed,
        noise_probe_every=scenario.noise_probe_every, slo=scenario.slo,
        tracer=recorder)
    results, rids = serve_trace(server, trace)
    return results, rids, _scenario_metrics(server, scenario, len(trace))


def _scenario_metrics(server: StreamServer, scenario: ChaosScenario,
                      n_requests: int) -> dict:
    snap = server.metrics.snapshot()
    snap.update({
        "scenario": scenario.name,
        "requests": n_requests,
        "served_all_admitted": snap["completed"] == snap["admitted"],
        "mesh_size_start": 1,
        "mesh_size_end": 1,
        "makespan_s": server.now(),
    })
    return snap


def swap_model_for(packed, scenario: ChaosScenario):
    """The weights a multi-tenant scenario hot-swaps in at ``swap_at``: one
    deterministic perturbed instance of the base model (same shapes —
    same-shape swaps add no engine shapes — different bits, reproducible
    from the scenario seed alone).  Exposed so tests can verify post-swap
    results bit-exact against the exact swapped model."""
    return perturb_packed(as_noise_key(scenario.seed + 7919), packed,
                          AnalogNoise(weight_sigma=scenario.swap_sigma))


def _run_multi_tenant(packed, scenario: ChaosScenario, *,
                      policy: BucketPolicy | None, recorder=None):
    """The multi-tenant leg of :func:`run_scenario`: every tenant serves
    the scenario model as its own registry entry (per-tenant covering
    bucket policy), the merged per-tenant traces replay on one fabric, and
    ``swap_tenant`` is hot-swapped to :func:`swap_model_for`'s weights at
    ``swap_at`` via a serve_trace control event."""
    registry = ModelRegistry()
    tagged = []
    for spec in scenario.tenants:
        trace = synth_arrival_trace(
            spec.n_requests, packed.n_in, mode=spec.arrivals, rate=spec.rate,
            slack=spec.slack, t_lo=spec.t_lo, t_hi=spec.t_hi,
            seed=scenario.seed + spec.seed_offset)
        p = policy if policy is not None else BucketPolicy.covering(
            [s.shape[0] for _, s, _ in trace], max_batch=4)
        registry.register(spec.name, packed, policy=p, weight=spec.weight)
        tagged.extend((t, s, d, spec.name) for t, s, d in trace)
    tagged.sort(key=lambda e: e[0])     # stable: ties keep tenant order
    control = []
    if scenario.swap_tenant is not None:
        swapped = swap_model_for(packed, scenario)
        control.append((scenario.swap_at,
                        lambda srv: srv.swap(scenario.swap_tenant, swapped)))
    server = StreamServer(
        registry, clock=VirtualClock(),
        queue_capacity=scenario.queue_capacity,
        backpressure=scenario.backpressure, overlong=scenario.overlong,
        service_model=lambda b, t: scenario.service_s,
        noise_probe_every=scenario.noise_probe_every, slo=scenario.slo,
        tracer=recorder)
    results, rids = serve_trace(server, tagged, control=control)
    return results, rids, _scenario_metrics(server, scenario, len(tagged))
