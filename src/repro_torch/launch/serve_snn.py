"""MENAGE serving launcher, in PyTorch: continuous batching of DVS event
streams on one device or a data-parallel mesh — closed-list or always-on
async.

  PYTHONPATH=src python -m repro_torch.launch.serve_snn --model both \
      --requests 48 [--device cuda|cpu] [--data 2] [--spoof-devices 2] \
      [--smoke] \
      [--arrivals poisson|bursty|diurnal|adversarial --rate 200 --slack 0.25] \
      [--noise-sigma 0.05] [--scenario NAME|all]

Requests are variable-length spike trains; the front end
(:mod:`repro_torch.engine.serving`) pads them into the policy's fixed
``(B, T)`` bucket grid (a bounded set of engine shapes, verified through
``trace_count``), and each bucket runs through the hand-written kernels
on the card (``--device cuda``, the default) or through their plain
PyTorch versions (``--device cpu``).  With no card, ``--device cuda``
raises; nothing falls back to the CPU on its own.

``--data N`` serves over an N-way mesh of cards
(:func:`repro_torch.engine.sharded_run.snn_serve_mesh`): every bucket's
batch is split over the cards, the model replicated on each, the buckets
rounded to multiples of N.  ``--spoof-devices N`` makes the mesh N logical
shards over the one ``--device`` instead (the CPU, or one card), the
counterpart of the reference's emulated N-device host; ``--data`` then
takes the first of them.  Asking for more cards than exist raises.
Without either flag the model serves on ``--device`` alone.

``--arrivals poisson|bursty|diurnal|adversarial`` switches from the
closed-list ``run_bucketed`` pass to the always-on loop
(:mod:`repro_torch.engine.stream_server`): a time-stamped arrival process
(:func:`repro_torch.engine.chaos.synth_arrival_trace`) replays through a
:class:`StreamServer` on a virtual clock, with per-request deadlines
(``--slack``) forcing partial bucket dispatches and a bounded arrival queue
applying backpressure.  ``--noise-sigma`` serves through a deterministic
noisy device instance (accuracy-under-noise shadow probes), and
``--scenario NAME|all`` replays named chaos scripts from
:data:`repro_torch.engine.chaos.SCENARIOS` instead (those that script
device loss need a mesh of 2 or more devices and are skipped without
one).  On a card every bucket refills one input buffer and replays its
CUDA graph (:mod:`repro_torch.engine.batched_run`)."""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.accelerator import MappedModel, map_model
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.layers import Conv2d, Dense, SumPool2d
from repro_torch.core.lif import LIFParams
from repro_torch.core.noise import AnalogNoise
from repro_torch.engine import (ARRIVAL_MODES, SCENARIOS, BucketPolicy,
                                StreamServer, VirtualClock, run_bucketed,
                                run_scenario, serve_trace, snn_serve_mesh,
                                synth_arrival_trace, trace_count)


def build_demo_model(kind: str, *, smoke: bool = False,
                     seed: int = 0) -> MappedModel:
    """A servable mapped model with random pruned weights (training is not
    the point of the serving path; spike statistics are).  ``mlp`` mirrors
    the paper's N-MNIST-style stack, ``conv`` the conv/pool/dense lowering.
    The same seed draws the reference launcher's weights."""
    rng = np.random.default_rng(seed)
    spec = AcceleratorSpec("serve-demo", n_cores=4, n_engines=8, n_caps=16,
                           weight_mem_bytes=1 << 20)
    lif = LIFParams(beta=0.85, threshold=0.6)
    if kind == "mlp":
        sizes = (64, 48, 10) if smoke else (256, 128, 64, 10)
        ws = []
        for i in range(len(sizes) - 1):
            w = rng.normal(0, 0.4, (sizes[i], sizes[i + 1])).astype(np.float32)
            w[np.abs(w) < np.quantile(np.abs(w), 0.6)] = 0
            ws.append(w)
        return map_model(ws, spec, lif=lif)
    if kind == "conv":
        c, side = (2, 6) if smoke else (2, 10)
        k = rng.normal(0, 0.6, (4, c, 3, 3)).astype(np.float32)
        k[rng.random(k.shape) > 0.6] = 0
        conv = Conv2d(kernel=k, in_shape=(c, side, side), stride=1, padding=1)
        pool = SumPool2d(conv.out_shape, 2)
        head = rng.normal(0, 0.4, (int(np.prod(pool.out_shape)), 10)) \
            .astype(np.float32)
        head[np.abs(head) < np.quantile(np.abs(head), 0.4)] = 0
        return map_model([conv, pool, Dense(w=head)], spec, lif=lif)
    raise ValueError(f"unknown model kind {kind!r} (mlp|conv)")


def synth_requests(n: int, n_in: int, *, t_lo: int = 4, t_hi: int = 30,
                   rate: float = 0.15, seed: int = 0) -> list[np.ndarray]:
    """A stream of n variable-length DVS-style requests ``[T_i, n_in]``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t_lo, t_hi + 1, size=n)
    return [(rng.random((int(t), n_in)) < rate).astype(np.float32)
            for t in lengths]


def serve_async(model, trace, *, policy: BucketPolicy, mesh=None,
                queue_capacity: int = 256, backpressure: str = "reject",
                service_model=None, max_events: int | None = None,
                with_stats: bool = False, noise=None, noise_key=0,
                tracer=None):
    """One async serving pass over an arrival trace (virtual clock);
    returns ``(results, rids, metrics)``.  ``metrics`` is the
    ``ServerMetrics`` snapshot plus the trajectory numbers: offered load,
    simulated-time throughput, wall seconds (host clock), and the count of
    new engine shapes.  ``tracer`` (a
    :class:`~repro_torch.engine.tracing.FlightRecorder`) enables
    per-request span tracing; ``mesh`` serves sharded over it."""
    server = StreamServer(model, policy=policy, mesh=mesh,
                          clock=VirtualClock(),
                          queue_capacity=queue_capacity,
                          backpressure=backpressure,
                          service_model=service_model,
                          max_events=max_events, with_stats=with_stats,
                          noise=noise, noise_key=noise_key, tracer=tracer)
    n0 = trace_count()
    t0 = time.perf_counter()
    results, rids = serve_trace(server, trace)
    wall = time.perf_counter() - t0
    snap = server.metrics.snapshot()
    makespan = max(server.now(), 1e-9)
    span = max(trace[-1][0] - trace[0][0], 1e-9) if len(trace) > 1 else 1e-9
    events = sum(t["events"] for t in server.telemetry)
    snap.update({
        "requests": len(trace),
        "offered_rps": len(trace) / span,
        "throughput_rps": snap["completed"] / makespan,
        "events_per_s": events / max(wall, 1e-9),
        "makespan_s": makespan,
        "wall_s": wall,
        "new_traces": trace_count() - n0,
        "n_buckets": server.policy.n_buckets,
    })
    return results, rids, snap


def serve_stream(model, streams, *, policy: BucketPolicy, mesh=None,
                 max_events: int | None = None, with_stats: bool = False):
    """One closed-list serving pass (sharded over ``mesh`` when given);
    returns (results, metrics): events/s, spikes/s, p50/p99 per-bucket step
    latency (host clock) and the count of new engine shapes."""
    telemetry: list[dict] = []
    n0 = trace_count()
    t0 = time.perf_counter()
    results = run_bucketed(model, streams, policy=policy, mesh=mesh,
                           max_events=max_events, with_stats=with_stats,
                           telemetry=telemetry)
    wall = time.perf_counter() - t0
    lat_ms = np.asarray([t["seconds"] for t in telemetry]) * 1e3
    events = sum(t["events"] for t in telemetry)
    spikes = sum(t["out_spikes"] for t in telemetry)
    metrics = {
        "requests": len(streams),
        "engine_steps": len(telemetry),
        "wall_s": wall,
        "events_per_s": events / max(wall, 1e-9),
        "spikes_per_s": spikes / max(wall, 1e-9),
        "p50_step_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0,
        "p99_step_ms": float(np.percentile(lat_ms, 99)) if len(lat_ms) else 0.0,
        "new_traces": trace_count() - n0,
        "n_buckets": policy.n_buckets,
    }
    return results, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "conv", "both"])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card "
                         "(raises with no card); cpu: their plain versions")
    ap.add_argument("--data", type=int, default=None,
                    help="serve over a mesh of this many devices (the "
                         "first N cards, or of the --spoof-devices shards)")
    ap.add_argument("--spoof-devices", type=int, default=None,
                    help="make the mesh N logical shards over the one "
                         "--device (the CPU or one card)")
    ap.add_argument("--max-events", type=int, default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arrivals", default="closed",
                    choices=["closed", *ARRIVAL_MODES],
                    help="closed: drain a fixed request list (run_bucketed);"
                         " otherwise: always-on async loop over a synthetic"
                         " arrival process (StreamServer) — poisson, bursty,"
                         " diurnal (day/night load swing), adversarial"
                         " (flood/famine with tight deadlines)")
    ap.add_argument("--noise-sigma", type=float, default=0.0,
                    help="serving-time analog noise: C2C-ladder gain error "
                         "sigma (core/noise.py); async arrivals only")
    ap.add_argument("--scenario", default=None,
                    help="replay a named chaos scenario from "
                         f"repro_torch.engine.chaos ({', '.join(SCENARIOS)}) "
                         "or 'all'; overrides --arrivals")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean offered load for async arrivals, requests/s")
    ap.add_argument("--slack", type=float, default=0.25,
                    help="per-request deadline slack, seconds after arrival")
    ap.add_argument("--queue-capacity", type=int, default=256,
                    help="async arrival-queue bound (backpressure kicks in)")
    args = ap.parse_args(argv)
    mesh = None
    if args.data is not None or args.spoof_devices is not None:
        mesh = snn_serve_mesh(args.data, device=args.device,
                              spoof=args.spoof_devices)
    n_shards = mesh.size if mesh is not None else 1
    where = (f"{n_shards}-way mesh" + ("" if mesh is None or mesh.real
                                       else " (spoofed)"))

    kinds = ["mlp", "conv"] if args.model == "both" else [args.model]
    n_req = min(args.requests, 16) if args.smoke else args.requests
    t_hi = 12 if args.smoke else 30
    if args.scenario is not None:
        names = list(SCENARIOS) if args.scenario == "all" else \
            [args.scenario]
        for kind in kinds:
            packed = build_demo_model(kind, smoke=args.smoke).pack(
                device=args.device)
            for name in names:
                sc = SCENARIOS[name]
                if sc.needs_mesh and n_shards < 2:
                    print(f"chaos/{kind}/{name}: SKIP (scripts device loss; "
                          f"needs a >= 2-device mesh: --data N or "
                          f"--spoof-devices N)")
                    continue
                _, _, m = run_scenario(packed, sc, mesh=mesh)
                print(f"chaos/{kind}/{name}: {m['completed']}/{m['requests']}"
                      f" served | miss rate {m['deadline_miss_rate']:.3f} | "
                      f"shed {m['shed']} rejected {m['rejected']} | mesh "
                      f"{m['mesh_size_start']}->{m['mesh_size_end']} | "
                      f"slo switches {m['slo_switches']} | noise agreement "
                      f"{m['noise_agreement']:.3f} "
                      f"({m['noise_probes']} probes)")
        return

    for kind in kinds:
        packed = build_demo_model(kind, smoke=args.smoke).pack(
            device=args.device)
        if args.arrivals != "closed":
            trace = synth_arrival_trace(n_req, packed.n_in,
                                        mode=args.arrivals, rate=args.rate,
                                        slack=args.slack, t_hi=t_hi, seed=1)
            policy = BucketPolicy.covering([s.shape[0] for _, s, _ in trace],
                                           n_shards=n_shards,
                                           max_batch=4 * n_shards)
            # instantaneous-service simulation: batch formation then depends
            # only on the (fixed) trace, so the warm replay sees exactly the
            # buckets the hot replay hits and the new-shape gate below is
            # deterministic
            svc = lambda b, t: 0.0  # noqa: E731
            noise = (AnalogNoise(weight_sigma=args.noise_sigma)
                     if args.noise_sigma > 0 else None)
            kw = dict(policy=policy, mesh=mesh,
                      queue_capacity=args.queue_capacity,
                      service_model=svc, max_events=args.max_events,
                      noise=noise)
            serve_async(packed, trace, **kw)
            results, rids, m = serve_async(packed, trace, **kw)
            if m["new_traces"]:
                raise RuntimeError("the hot async pass met new engine shapes")
            preds = [int(results[r].out_spikes.sum(axis=0).argmax())
                     for r in rids[:8] if r is not None and r in results]
            print(f"serve-async/{kind} [{args.arrivals}]: "
                  f"{m['completed']}/{m['requests']} reqs on "
                  f"{packed.device}, {where} | offered "
                  f"{m['offered_rps']:.0f} "
                  f"rps, served {m['throughput_rps']:.0f} rps | latency "
                  f"p50 {m['p50_latency_s']*1e3:.1f} ms p99 "
                  f"{m['p99_latency_s']*1e3:.1f} ms | miss rate "
                  f"{m['deadline_miss_rate']:.3f} | fill "
                  f"{m['bucket_fill_ratio']:.2f} | forced "
                  f"{m['forced_dispatches']}/{m['dispatches']} | "
                  f"buckets<= {m['n_buckets']} | input buffers "
                  f"{len(packed.input_buffers)} | wall "
                  f"{m['wall_s']*1e3:.0f} ms | sample preds {preds}")
            continue
        streams = synth_requests(n_req, packed.n_in, t_hi=t_hi, seed=1)
        policy = BucketPolicy.covering([s.shape[0] for s in streams],
                                       n_shards=n_shards,
                                       max_batch=4 * n_shards)
        # see every bucket this stream touches, then measure a hot pass
        serve_stream(packed, streams, policy=policy, mesh=mesh,
                     max_events=args.max_events)
        results, m = serve_stream(packed, streams, policy=policy, mesh=mesh,
                                  max_events=args.max_events)
        if m["new_traces"]:
            raise RuntimeError("the hot serving pass met new engine shapes")
        preds = [int(r.out_spikes.sum(axis=0).argmax()) for r in results[:8]]
        print(f"serve/{kind}: {m['requests']} reqs on {packed.device}, "
              f"{where} in {m['wall_s']*1e3:.0f} ms | "
              f"{m['events_per_s']/1e3:.1f}k events/s, "
              f"{m['spikes_per_s']/1e3:.1f}k spikes/s | "
              f"step p50 {m['p50_step_ms']:.1f} ms p99 "
              f"{m['p99_step_ms']:.1f} ms | "
              f"buckets<= {m['n_buckets']} | sample preds {preds}")


if __name__ == "__main__":
    main()
