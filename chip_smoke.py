#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, one line each:

  1. build     the CUDA kernels of src/repro_torch/kernels/csrc with nvcc
  2. kernels   every kernel of the serving path against its plain PyTorch
               version on the card, bit-exact, at the shapes the serving
               run gives it, with times; and c2c_matmul, the int8-weight
               C2C-ladder MAC that no serving path runs, at the reference
               benchmark's shape and as a dense input layer of the model
  3. serve     the paper's CIFAR10-DVS MLP at the sensor's native width
               (32768 -> 1000 -> 500 -> 200 -> 100 -> 10, seeded random
               weights, 50 % magnitude-pruned, 8-bit, Accel_2) through
               map_model, pack_model and run_bucketed on the card; checked
               against the port's CPU path and its packed-operand route;
               then one engine call of the largest bucket broken down by
               stage (host clock) and by device kernel (profiler)
  4. stream    the same packed model behind the always-on StreamServer
               (serve_snn's serve_async, virtual clock, a bursty arrival
               trace of rate-map requests, per-bucket service times
               measured on the card): every served request equal to the
               closed-list run, no new engine shapes on the counted pass,
               at most one input buffer per bucket, a noisy device
               instance reproducible, and the flight recorder's spans
  5. nmnist4   the N-MNIST MLP at 4 bits on Accel_1 through the packed
               kernel, bit-exact against the numpy oracle ``run``

then the card's name and power limit, one JSON line of kernel results, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; it also refuses to run with no
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_REQUESTS = 8
N_STREAM = 32                # requests of the stream phase's arrival trace
LENGTHS = (8, 25)            # request lengths are drawn from this range
GAINS = (1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)
MIN_RATE = 0.02              # least spike rate the gain must give each layer
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12       # float32 outside the tensor cores, same sheet


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pruned_mlp(rng: np.random.Generator, sizes, gain: float = 1.0):
    """Seeded N(0, 1/n_in) weights, the smaller-magnitude half set to 0."""
    ws = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = rng.standard_normal((a, b), dtype=np.float32) / np.float32(np.sqrt(a))
        th = np.partition(np.abs(w).ravel(), w.size // 2)[w.size // 2]
        w[np.abs(w) < th] = 0
        ws.append(w * np.float32(gain))
    return ws


def pick_gain(ws, x: torch.Tensor, lif) -> float:
    """The smallest gain from GAINS at which every layer of the float model
    fires at MIN_RATE or more on ``x`` [B, T, n_in] (random weights at gain
    1 go silent after the second layer)."""
    from repro_torch.kernels.lif_update import lif_scan_plain
    for gain in GAINS:
        s, rates = x, []
        for w in ws:
            cur = s @ (torch.from_numpy(w).to(x.device) * gain)
            s = lif_scan_plain(cur.contiguous(), lif)
            rates.append(s.mean().item())
        if min(rates) >= MIN_RATE:
            return gain
    raise SystemExit(f"FAILED: no gain in {GAINS} makes every layer fire")


def rate_map_streams(rng, cfg, lengths) -> list[np.ndarray]:
    """Requests of the given lengths drawn from the dataset's class rate
    maps, class ``i % num_classes`` for request ``i``."""
    from repro_torch.data.events import _class_rate_maps
    maps = _class_rate_maps(cfg).reshape(cfg.num_classes, -1)
    return [(rng.random((int(t), cfg.n_in), dtype=np.float32)
             < maps[i % cfg.num_classes]).astype(np.float32)
            for i, t in enumerate(lengths)]


def make_requests(rng, cfg, n: int) -> list[np.ndarray]:
    return rate_map_streams(rng, cfg,
                            rng.integers(LENGTHS[0], LENGTHS[1] + 1, n))


def padded(streams, plan, n_in: int, device) -> torch.Tensor:
    x = np.zeros((plan.b_pad, plan.t_pad, n_in), dtype=np.float32)
    for row, i in enumerate(plan.indices):
        x[row, :streams[i].shape[0]] = streams[i]
    return torch.from_numpy(x).to(device)


def phase_kernels(dense, packed, x: torch.Tensor) -> list[dict]:
    """Each kernel against its plain version on the inputs every layer sees
    for the padded bucket ``x``; times and bounds at the input layer."""
    from repro_torch.engine.batched_run import _forward_impl
    from repro_torch.kernels import event_synapse as es
    from repro_torch.kernels import lif_update as lu
    from repro_torch.kernels import ops

    b, t, _ = x.shape
    ins = [x] + _forward_impl(dense, x, None)[:-1]
    err = {"event_synapse": 0.0, "event_synapse_packed": 0.0,
           "lif_update": 0.0}
    for li, (dl, pl) in enumerate(zip(dense.layers, packed.layers)):
        spikes = ins[li].reshape(b * t, dl.n_src).contiguous()
        ev = ops.events_from_spikes(spikes, dl.n_src)
        cur = ops.event_synapse(ev, dl.w_fused)
        ref = es.event_synapse_plain(ev, dl.w_fused)
        require(torch.equal(cur, ref), f"event_synapse layer {li}")
        pk = ops.event_synapse_packed(ev, pl.w_packed, pl.scale, bits=pl.bits)
        pk_ref = es.event_synapse_packed_plain(ev, pl.w_packed, pl.scale,
                                               pl.bits)
        require(torch.equal(pk, pk_ref), f"event_synapse_packed layer {li}")
        require(torch.equal(pk[:, :dl.n_dest], cur[:, :dl.n_dest]),
                f"packed vs dense currents layer {li}")
        c3 = cur.reshape(b, t, dl.n_dest_pad)
        lif = dense.lif
        s, s_ref = ops.lif_scan(c3, lif), lu.lif_scan_plain(c3, lif)
        require(torch.equal(s, s_ref), f"lif_scan layer {li}")
        v0 = c3[:, 0].contiguous()
        i0 = c3[:, -1].contiguous()
        one = ops.lif_update(v0, i0, beta=lif.beta, threshold=lif.threshold,
                             v_reset=lif.v_reset)
        one_ref = lu.lif_update_plain(v0, i0, lif.beta, lif.threshold,
                                      lif.v_reset)
        require(torch.equal(one[0], one_ref[0])
                and torch.equal(one[1], one_ref[1]), f"lif_update layer {li}")
        err["event_synapse"] = max(err["event_synapse"],
                                   (cur - ref).abs().max().item())
        err["event_synapse_packed"] = max(err["event_synapse_packed"],
                                          (pk - pk_ref).abs().max().item())
        err["lif_update"] = max(err["lif_update"],
                                (s - s_ref).abs().max().item())

    # times and bounds at the input layer, the widest
    dl, pl = dense.layers[0], packed.layers[0]
    spikes = x.reshape(b * t, dl.n_src).contiguous()
    ev = ops.events_from_spikes(spikes, dl.n_src)
    valid = ev >= 0
    n_valid = int(valid.sum())
    n_rows_read = int(torch.unique(ev[valid]).numel())
    r, n_dest = ev.shape[0], dl.n_dest_pad
    out_bytes = r * n_dest * 4
    bytes_dense = n_valid * 4 + n_rows_read * n_dest * 4 + out_bytes
    bytes_packed = n_valid * 4 + n_rows_read * n_dest * pl.bits // 8 + out_bytes
    flops = n_valid * n_dest
    c3 = es.event_synapse_plain(ev, dl.w_fused).reshape(b, t, n_dest)
    lif_bytes = 2 * c3.numel() * 4

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [
        dict(name="event_synapse",
             source="src/repro_torch/kernels/csrc/event_synapse.cu",
             replaces="src/repro/kernels/event_synapse.py:49",
             ms=cuda_ms(lambda: ops.event_synapse(ev, dl.w_fused)),
             plain_ms=cuda_ms(lambda: es.event_synapse_plain(ev, dl.w_fused),
                              reps=2),
             bound=(bytes_dense, flops),
             library_ms=cuda_ms(lambda: torch.matmul(spikes, dl.w_fused))),
        dict(name="event_synapse_packed",
             source="src/repro_torch/kernels/csrc/event_synapse.cu",
             replaces="src/repro/kernels/event_synapse.py:124",
             ms=cuda_ms(lambda: ops.event_synapse_packed(
                 ev, pl.w_packed, pl.scale, bits=pl.bits)),
             plain_ms=cuda_ms(lambda: es.event_synapse_packed_plain(
                 ev, pl.w_packed, pl.scale, pl.bits), reps=2),
             bound=(bytes_packed, 2 * flops), library_ms=None),
        dict(name="lif_update",
             source="src/repro_torch/kernels/csrc/lif_update.cu",
             replaces="src/repro/kernels/lif_update.py:32",
             ms=cuda_ms(lambda: ops.lif_scan(c3, dense.lif)),
             plain_ms=cuda_ms(lambda: lu.lif_scan_plain(c3, dense.lif)),
             bound=(lif_bytes, 4 * c3.numel()), library_ms=None),
    ]
    for row in rows:
        row.update(route="cuda", max_abs_err=err[row["name"]],
                   **bound(*row.pop("bound")))
        log("kernel", name=row["name"], ms=round(row["ms"], 4),
            plain_ms=round(row["plain_ms"], 4),
            bound_ms=round(row["bound_ms"], 4), bound_by=row["bound_by"],
            library_ms=None if row["library_ms"] is None
            else round(row["library_ms"], 4),
            shape=f"events[{r},{ev.shape[1]}]x{dl.n_src}x{n_dest}",
            valid_events=n_valid)
    return rows


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_c2c(w1: np.ndarray, x: torch.Tensor) -> dict:
    """c2c_matmul against its plain version on the card at two shapes: the
    reference benchmark's (256, 1024, 1024), and the model's input layer as
    a dense MAC — the largest bucket's raster ``x`` as ``[B*T, 32768]``
    times the int8 ``quantize_symmetric`` codes of layer 1's weights ``w1``
    padded to 1024 columns.  Returns the kernels-line row, at the second.

    Tolerance, elementwise: ``2 (K + 1) 2**-24 (|x| @ |w_q|) |scale|``,
    twice the float32 rounding bound of a K-term sum taken in any order
    plus the rounding of the scale — the kernel splits K and sums in
    another order than the plain matmul, so bit-equality is not promised;
    at the benchmark shape also the reference's ``rtol 1e-4, atol 1e-3``.
    With 0/1 spikes and integer codes every partial sum is an integer below
    2**24, exact in any order, so there the two agree bit for bit."""
    from repro_torch.core.quant import quantize_symmetric
    from repro_torch.kernels import c2c_matmul as c2c
    from repro_torch.kernels import ops

    dev = x.device
    rng = np.random.default_rng(SEED + 4)
    xb = torch.from_numpy(rng.standard_normal((256, 1024), dtype=np.float32))
    wb = torch.from_numpy(rng.integers(-128, 128, (1024, 1024))
                          .astype(np.int8))
    qt = quantize_symmetric(w1, bits=8)
    n_pad = -(-w1.shape[1] // 1024) * 1024
    wq = np.zeros((w1.shape[0], n_pad), dtype=np.int8)
    wq[:, :w1.shape[1]] = qt.q
    cases = {"bench": (xb.to(dev), wb.to(dev), 0.01),
             "cifar_l1": (x.reshape(-1, x.shape[-1]).contiguous(),
                          torch.from_numpy(wq).to(dev), float(qt.scale))}
    row = None
    for label, (xc, wc, scale) in cases.items():
        m, k = xc.shape
        n = wc.shape[1]
        got = ops.c2c_matmul(xc, wc, scale)
        plain = c2c.c2c_matmul_plain(xc, wc, scale)
        torch.cuda.synchronize()
        err = (got - plain).abs()
        tol = (2 * (k + 1) * 2.0 ** -24) * (xc.abs() @ wc.float().abs()) \
            * abs(scale)
        require(bool((err <= tol).all()), f"c2c_matmul {label} within the "
                f"summation bound (max err {err.max().item()})")
        if label == "bench":
            torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-3)
        torch.backends.cuda.matmul.allow_tf32 = False
        r = dict(name="c2c_matmul", route="cuda",
                 source="src/repro_torch/kernels/csrc/c2c_matmul.cu",
                 replaces="src/repro/kernels/c2c_matmul.py:42",
                 on_path="standalone (no path of the JAX package runs it)",
                 max_abs_err=err.max().item(),
                 ms=cuda_ms(lambda: ops.c2c_matmul(xc, wc, scale), reps=20),
                 plain_ms=cuda_ms(lambda: c2c.c2c_matmul_plain(xc, wc, scale),
                                  reps=20),
                 library_ms=cuda_ms(lambda: xc @ (wc.float() * scale),
                                    reps=20),
                 **bound(4 * m * k + k * n + 4 * m * n, 2 * m * k * n))
        log("kernel", name="c2c_matmul", shape=f"{label}:{m}x{k}x{n}",
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 4),
            bound_ms=round(r["bound_ms"], 4), bound_by=r["bound_by"],
            library_ms=round(r["library_ms"], 4),
            max_abs_err=r["max_abs_err"], max_tol=tol.max().item())
        row = r
    return row


def service_model(policy, telemetry) -> dict:
    """Each bucket's service seconds from measured engine calls: the mean
    of the bucket's calls, or for a bucket with none the mean seconds per
    padded (B, T) cell times B*T."""
    per_bucket: dict = {}
    for rec in telemetry:
        per_bucket.setdefault((rec["b_pad"], rec["t_pad"]), []).append(
            rec["seconds"])
    per_cell = (sum(r["seconds"] for r in telemetry)
                / sum(r["b_pad"] * r["t_pad"] for r in telemetry))
    return {(b, t): (float(np.mean(per_bucket[(b, t)]))
                     if (b, t) in per_bucket else per_cell * b * t)
            for b in policy.batch_sizes for t in policy.time_steps}


def phase_stream(dense, streams_of, policy, calib) -> dict:
    """The always-on path: serve_async (StreamServer, virtual clock) over a
    bursty arrival trace whose streams are CIFAR10-DVS rate-map requests,
    on the already packed model; every check raises on failure.

    Service times: a first warm pass runs on ``calib``, the serve phase's
    engine calls; those include the host accounting that serving with
    ``with_stats=False`` skips, so the counted pass runs on the per-bucket
    engine seconds that first pass measured (a second warm pass on them
    first, so the counted pass meets no bucket it has not seen)."""
    from repro_torch.core.noise import AnalogNoise
    from repro_torch.engine import (FlightRecorder, StreamServer,
                                    VirtualClock, run_bucketed, serve_trace)
    from repro_torch.engine.chaos import synth_arrival_trace
    from repro_torch.kernels import _build
    from repro_torch.launch.serve_snn import serve_async

    # arrival times, lengths and deadlines of the bursty process; the
    # streams are swapped for rate-map requests of the same lengths
    base = synth_arrival_trace(N_STREAM, 1, mode="bursty", t_lo=LENGTHS[0],
                               t_hi=LENGTHS[1], seed=SEED)
    streams = streams_of([s.shape[0] for _, s, _ in base])
    trace = [(t, s, d) for (t, _, d), s in zip(base, streams)]
    first = service_model(policy, calib)
    warm = StreamServer(dense, policy=policy, clock=VirtualClock(),
                        service_model=lambda b, t: first[(b, t)])
    serve_trace(warm, trace)                              # warm, measures
    service = service_model(policy, warm.telemetry)
    kw = dict(policy=policy, service_model=lambda b, t: service[(b, t)],
              with_stats=False)
    serve_async(dense, trace, **kw)                       # warm
    torch.cuda.synchronize()
    _build.reset_launches()
    results, rids, m = serve_async(dense, trace, **kw)    # counted
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(counts["event_synapse"] > 0 and counts["lif_update"] > 0,
            f"stream launches {counts}")
    require(m["completed"] + m["rejected"] + m["shed"] == len(trace),
            f"stream conserves requests: {m['completed']} completed, "
            f"{m['rejected']} rejected, {m['shed']} shed of {len(trace)}")
    require(m["new_traces"] == 0, f"counted stream pass met "
            f"{m['new_traces']} new engine shapes")
    n_buffers = len(dense.input_buffers)
    require(0 < n_buffers <= policy.n_buckets,
            f"{n_buffers} input buffers for {policy.n_buckets} buckets")
    closed = run_bucketed(dense, streams, policy=policy, with_stats=False)
    served = [i for i, r in enumerate(rids) if r is not None]
    require(all(np.array_equal(results[rids[i]].out_spikes,
                               closed[i].out_spikes) for i in served),
            "stream results equal the closed-list run")

    noise = AnalogNoise(weight_sigma=0.05)
    noisy = [serve_async(dense, trace, noise=noise, noise_key=0, **kw)
             for _ in range(2)]
    require(noisy[0][1] == noisy[1][1]
            and all(np.array_equal(noisy[0][0][r].out_spikes,
                                   noisy[1][0][r].out_spikes)
                    for r in noisy[0][0]),
            "AnalogNoise(0.05) seed 0 served twice gives identical spikes")
    pred = {r: int(res.out_spikes.sum(0).argmax())
            for r, res in results.items()}
    agree = float(np.mean([int(noisy[0][0][r].out_spikes.sum(0).argmax())
                           == pred[r] for r in pred]))

    rec = FlightRecorder()
    serve_async(dense, trace, tracer=rec, **kw)
    rec.detach_jit_probe()
    last = rec.last()
    kinds = [sp.kind for sp in last.spans] if last is not None else []
    require(all(k in kinds for k in ("pad", "dispatch", "slice")),
            f"traced request spans {kinds}")

    return dict(requests=len(trace), completed=m["completed"],
                rejected=m["rejected"] + m["shed"],
                dispatches=m["dispatches"],
                forced_dispatches=m["forced_dispatches"],
                fill=round(m["bucket_fill_ratio"], 4),
                p50_latency_s=m["p50_latency_s"],
                p99_latency_s=m["p99_latency_s"],
                deadline_miss_rate=round(m["deadline_miss_rate"], 4),
                wall_s=round(m["wall_s"], 4),
                requests_per_s=round(m["completed"] / m["wall_s"], 2),
                noise_agreement=agree,
                noise_probes=noisy[0][2]["noise_probes"],
                noise_probe_agreement=round(noisy[0][2]["noise_agreement"],
                                            4),
                input_buffers=n_buffers, n_buckets=policy.n_buckets,
                launches=json.dumps(counts),
                service_ms=json.dumps({f"{b}x{t}": round(v * 1e3, 3)
                                       for (b, t), v in service.items()}),
                closed_equal=True, new_shapes=0, noise_repeatable=True,
                spans=",".join(dict.fromkeys(kinds)))


def phase_breakdown(packed, streams, plan) -> dict:
    """Where one engine call of ``plan`` goes: each stage of run_batched
    timed on the host clock around synchronised work, and the device's busy
    time (kernels and copies) from the profiler over the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.batched_run import _finalize, _forward_impl

    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    n_in = packed.n_in
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host = stage("pad", lambda: padded(streams, plan, n_in, "cpu")
                     .numpy())
        x = stage("h2d", lambda: torch.from_numpy(host).to(packed.device))
        outs = stage("forward", lambda: _forward_impl(packed, x, None))
        outs = stage("d2h", lambda: [o.cpu().numpy() for o in outs])
        stage("stats", lambda: _finalize(packed, host, outs, None, None,
                                         True))
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name if "Memcpy" in e.name else e.name.split("<")[0]
            device[key] = device.get(key, 0.0) + e.device_time_total / 1e3
    wall = sum(stages.values())
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    return dict(bucket=f"{plan.b_pad}x{plan.t_pad}",
                stage_ms=json.dumps({k: round(v, 3)
                                     for k, v in stages.items()}),
                wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
                device_idle_share=round(1 - busy / wall, 4),
                device_ms=json.dumps({k: round(v, 3) for k, v in top}))


def same_result(a, b) -> bool:
    fields = ("cycles", "rows_touched", "engine_ops", "events",
              "sn_bytes_touched")
    return (np.array_equal(a.out_spikes, b.out_spikes)
            and len(a.stats) == len(b.stats)
            and all(np.array_equal(getattr(x, f), getattr(y, f))
                    and x.mem_e_peak == y.mem_e_peak
                    for x, y in zip(a.stats, b.stats) for f in fields))


def drive(packed, streams, policy, telemetry=None):
    """One counted run of the main path: the counts go to 0 just before it
    and are read just after."""
    from repro_torch.engine import run_bucketed
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_bucketed(packed, streams, policy=policy, telemetry=telemetry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, dict(_build.launches), seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.menage_paper import (ACCEL_1, ACCEL_2,
                                                  CIFAR_DATA, CIFAR_SNN,
                                                  NMNIST_DATA, NMNIST_SNN)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.engine import BatchPlan, BucketPolicy, plan_batches
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. build
    build_s = _build.build_all()
    regs = {name: [ln.split("Used ")[1].split(",")[0]
                   for ln in text.splitlines() if "Used " in ln]
            for name, text in _build.build_log.items()}
    log("build", seconds=round(build_s, 2), torch=torch.__version__,
        cuda=torch.version.cuda, ptxas=json.dumps(regs))

    # the CIFAR10-DVS MLP at native width, on Accel_2
    rng = np.random.default_rng(SEED)
    streams = make_requests(rng, CIFAR_DATA, N_REQUESTS)
    policy = BucketPolicy(batch_sizes=(4, 8), time_steps=(16, 32))
    plans = plan_batches([s.shape[0] for s in streams], policy)
    big = max(plans, key=lambda p: p.b_pad * p.t_pad)
    x_big = padded(streams, big, CIFAR_SNN.layer_sizes[0], dev)
    ws = pruned_mlp(np.random.default_rng(SEED + 1), CIFAR_SNN.layer_sizes)
    gain = pick_gain(ws, x_big, CIFAR_SNN.lif)
    ws = [w * np.float32(gain) for w in ws]
    t0 = time.perf_counter()
    mapped = map_model(ws, ACCEL_2, lif=CIFAR_SNN.lif)
    map_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dense = mapped.pack(device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack_mib = (torch.cuda.memory_allocated() - mem0) / 2**20
    packed = mapped.pack(packed_ops=True, device=dev)
    log("map", model="cifar10_dvs", sizes=list(CIFAR_SNN.layer_sizes),
        accel=ACCEL_2.name, gain=gain, map_s=round(map_s, 2),
        pack_s=round(pack_s, 2), pack_mib=round(pack_mib, 1),
        rounds=[len(l.rounds) for l in mapped.layers],
        sram_bytes=[l.sram_bytes for l in mapped.layers])

    # 2. kernels against their plain versions, at the main path's shapes
    kernels = phase_kernels(dense, packed, x_big)
    kernels.append(phase_c2c(ws[0], x_big))

    # 3. serve: warm once, then the counted run of the dense route
    drive(dense, streams, policy)
    telemetry = []
    res, counts, seconds = drive(dense, streams, policy, telemetry)
    require(all(counts[k] > 0 for k in ("event_synapse", "lif_update")),
            f"dense route launches {counts}")
    n_layers = len(mapped.layers)
    layer_spikes = [int(sum(r.stats[li + 1].events.sum() for r in res))
                    for li in range(n_layers - 1)]
    layer_spikes.append(int(sum(r.out_spikes.sum() for r in res)))
    require(all(n > 0 for n in layer_spikes),
            f"every layer spikes: {layer_spikes}")
    for r, s in zip(res, streams):
        require(r.out_spikes.shape == (s.shape[0], CIFAR_SNN.layer_sizes[-1])
                and np.isfinite(r.out_spikes).all(), "output shape")
    res_pk, counts_pk, _ = drive(packed, streams, policy)
    require(counts_pk["event_synapse_packed"] > 0
            and counts_pk["lif_update"] > 0, f"packed launches {counts_pk}")
    require(all(same_result(a, b) for a, b in zip(res, res_pk)),
            "packed route equals dense route")
    cpu = mapped.pack(device="cpu")
    from repro_torch.engine import run_bucketed
    res_cpu = run_bucketed(cpu, streams[:2], policy=policy)
    require(all(same_result(a, b) for a, b in zip(res[:2], res_cpu)),
            "card equals the CPU path")
    log("serve", requests=len(streams),
        lengths=[s.shape[0] for s in streams],
        plans=[(p.b_pad, p.t_pad) for p in plans],
        layer_spikes=layer_spikes, launches=json.dumps(counts),
        packed_launches=json.dumps(counts_pk), seconds=round(seconds, 4),
        requests_per_s=round(len(streams) / seconds, 2),
        cpu_equal=True, packed_equal=True)
    log("breakdown", **phase_breakdown(dense, streams, big))

    # 4. stream: the always-on server in front of the same packed model
    rng_s = np.random.default_rng(SEED + 5)
    log("stream", **phase_stream(
        dense, lambda lengths: rate_map_streams(rng_s, CIFAR_DATA, lengths),
        policy, telemetry))

    # 5. the N-MNIST MLP at 4 bits, packed kernel, against the oracle
    rng4 = np.random.default_rng(SEED + 2)
    streams4 = make_requests(rng4, NMNIST_DATA, 2)
    both = BatchPlan(indices=(0, 1), b_pad=2,
                     t_pad=max(s.shape[0] for s in streams4))
    x4 = padded(streams4, both, NMNIST_SNN.layer_sizes[0], dev)
    ws4 = pruned_mlp(np.random.default_rng(SEED + 3), NMNIST_SNN.layer_sizes)
    gain4 = pick_gain(ws4, x4, NMNIST_SNN.lif)
    mapped4 = map_model([w * np.float32(gain4) for w in ws4], ACCEL_1,
                        lif=NMNIST_SNN.lif, quant_bits=4)
    res4, counts4, _ = drive(mapped4.pack(device=dev), streams4, policy)
    require(counts4["event_synapse_packed"] > 0 and counts4["lif_update"] > 0,
            f"4-bit launches {counts4}")
    for r, s in zip(res4, streams4):
        oracle = run(mapped4, s)
        require(np.array_equal(r.out_spikes, oracle.out_spikes)
                and all(np.array_equal(a.cycles, b.cycles)
                        and np.array_equal(a.engine_ops, b.engine_ops)
                        for a, b in zip(r.stats, oracle.per_layer_stats)),
                "4-bit route equals the oracle")
    log("nmnist4", accel=ACCEL_1.name, gain=gain4,
        out_spikes=[int(r.out_spikes.sum()) for r in res4],
        launches=json.dumps(counts4), oracle_equal=True)

    for row in kernels:
        row["launches"] = (counts_pk if row["name"] == "event_synapse_packed"
                           else counts)[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "on_path")
    print(card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
