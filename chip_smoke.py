#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, one line each:

  1. build     the CUDA kernels of src/repro_torch/kernels/csrc with nvcc
  2. kernels   every kernel against its plain PyTorch version on the card,
               bit-exact, at the shapes the serving run gives it, with times
  3. serve     the paper's CIFAR10-DVS MLP at the sensor's native width
               (32768 -> 1000 -> 500 -> 200 -> 100 -> 10, seeded random
               weights, 50 % magnitude-pruned, 8-bit, Accel_2) through
               map_model, pack_model and run_bucketed on the card; checked
               against the port's CPU path and its packed-operand route;
               then one engine call of the largest bucket broken down by
               stage (host clock) and by device kernel (profiler)
  4. nmnist4   the N-MNIST MLP at 4 bits on Accel_1 through the packed
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


def make_requests(rng, cfg, n: int) -> list[np.ndarray]:
    from repro_torch.data.events import _class_rate_maps
    maps = _class_rate_maps(cfg).reshape(cfg.num_classes, -1)
    lengths = rng.integers(LENGTHS[0], LENGTHS[1] + 1, n)
    return [(rng.random((t, cfg.n_in), dtype=np.float32)
             < maps[i % cfg.num_classes]).astype(np.float32)
            for i, t in enumerate(lengths)]


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
        nbytes, nops = row.pop("bound")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOP_PER_S * 1e3
        row.update(route="cuda", max_abs_err=err[row["name"]],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("kernel", name=row["name"], ms=round(row["ms"], 4),
            plain_ms=round(row["plain_ms"], 4),
            bound_ms=round(row["bound_ms"], 4), bound_by=row["bound_by"],
            library_ms=None if row["library_ms"] is None
            else round(row["library_ms"], 4),
            shape=f"events[{r},{ev.shape[1]}]x{dl.n_src}x{n_dest}",
            valid_events=n_valid)
    return rows


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


def drive(packed, streams, policy):
    """One counted run of the main path: the counts go to 0 just before it
    and are read just after."""
    from repro_torch.engine import run_bucketed
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_bucketed(packed, streams, policy=policy)
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

    # 3. serve: warm once, then the counted run of the dense route
    drive(dense, streams, policy)
    res, counts, seconds = drive(dense, streams, policy)
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

    # 4. the N-MNIST MLP at 4 bits, packed kernel, against the oracle
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
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
