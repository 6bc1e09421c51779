#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, one line each:

  1. build     the CUDA kernels of src/repro_torch/kernels/csrc with nvcc
  2. kernels   every kernel of the serving path against its plain PyTorch
               version on the card, bit-exact, at the shapes the serving
               run gives it, with times; the packed kernel also at 4 and 2
               bits at the input layer's events; lif_scan also at
               [8, 32, 1024], with its device time per launch, the host's
               issue time per call and the launch floor; and c2c_matmul,
               the int8-weight C2C-ladder MAC that no serving path runs, at
               the reference benchmark's shape and as a dense input layer
               of the model
     event_lists  both event_synapse routes on event lists with interior
               -1s, against their plain versions, and an unsorted row
               refused
     sync_free one engine forward of each route under
               torch.cuda.set_sync_debug_mode("error")
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
  6. socket    the wire front end: a SpikeSocketServer on 127.0.0.1 with
               two tenants on the card, the CIFAR10-DVS MLP (dense route,
               default) and the 4-bit N-MNIST MLP, driven by SpikeClients
               over loopback: rate-map requests (one as a v1 frame), a
               bad-shape and an overlong request, a corrupt connection, an
               ADMIN hot-swap of the CIFAR tenant to its packed route,
               ADMIN list / metrics / trace; every result bit-exact against
               run_bucketed or the oracle, all three serving kernels
               launched in the phase
  7. precision the per-layer bit-width search (search_bits, budget 0.05) on
               the N-MNIST MLP at native width (2312 -> 200 -> 100 -> 40 ->
               10, Accel_1, seeded, 50 % pruned) over a 25-step rate-map
               probe; then all-8, all-4, all-2 and the searched mixed widths
               each mapped, packed with packed_ops=True on the card and
               serving 8 requests through run_bucketed, every request
               bit-exact against the oracle (spikes, dispatch stats,
               energy); one Pareto point per configuration, events/s from
               the card, the packed kernel's launches by width
  8. spikify   spikified_ffn at InternLM2-1.8B's FFN widths (d_model 2048,
               d_ff 8192, a ReLU FFN, seeded weights, 16 tokens) at T = 16,
               64 and 256 through the dense event_synapse kernel: the T = 64
               launch (1024 rows of 8192-wide event lists) equal to the
               plain version, the 1/sqrt(T) law and the correlation with the
               dense FFN held, the kernel's time beside its bound and the
               library matmul
  9. train     training on the card through train_snn_model (Table I's
               Adam: lr 1e-3, b2 0.999, no decay or clipping), one line
               per model: the N-MNIST MLP at native width (2312 -> 200 ->
               100 -> 40 -> 10, batch 64, grad_shards 8, 40 steps;
               stopped at 20 and resumed from its checkpoint, equal to the
               uninterrupted run bit for bit; the first 3 losses against
               the CPU path), pruned, quantized to 8 bits, mapped onto
               Accel_1 and served on both event_synapse routes against the
               oracle; the CIFAR10-DVS MLP at native width (33.4 M
               parameters, batch 16, 10 steps: step 1 against the CPU
               path, step ms, samples/s, peak device memory); the conv
               SNN (CIFAR_CONV, batch 32, 20 steps) lowered with
               layer_specs onto Accel_2 and served on the dense kernel
               against the oracle; one train step of each family under
               set_sync_debug_mode("error"); the launch counts of the
               serving ends
 10. mesh      the data-parallel mesh, 2-way: cuda:0 and cuda:1 where the
               host has two cards, else two spoofed shards of the one
               (``mesh:`` line).  ``mesh_serve:`` the native-width
               CIFAR10-DVS MLP's 8 requests on the dense and the packed
               route through run_bucketed(mesh=) on covering(n_shards=2)
               buckets, equal to the single-device call (spikes, dispatch
               stats, utilization, overflow) and for the shortest
               request to the oracle, each shard launching every layer's
               kernels (twice a single-device call's launches), both
               calls' wall time; ``mesh_chaos:`` the device_loss and
               blackout scenarios on that model, each replayed twice:
               deterministic, the mesh 2 -> 1, every admitted request
               served and equal to a single-device run; ``mesh_train:``
               the native-width CIFAR10-DVS MLP 3 steps on the mesh
               against 3 single-device steps at grad_shards=2, bit for
               bit, a mesh step under set_sync_debug_mode("error"),
               CIFAR_CONV 2 steps on the mesh with a checkpoint resumed on
               a 1-way mesh to step 4, bit for bit, and the trained conv
               SNN served across the mesh against the oracle
 11. lm        the LM serving path, which runs no hand-written kernel
               (``kernel_launches=0``, each kernel's count set to 0 before
               the phase and read after it).  ``lm_serve:`` InternLM2-1.8B
               at full width (24 layers, d_model 2048, GQA 16/8, vocab
               92544) in bf16, seeded, through launch.serve's ``serve``: 8
               prompts of 128 tokens from the token pipeline, 32 tokens
               each; prefill ms, decode ms a step beside the bytes bound
               of the weights a step reads, tokens/s, peak MiB; one
               request's decode of token 128 against the full forward over
               129 tokens, a decode step under set_sync_debug_mode("error"),
               the card against the CPU at full width cut to 2 layers (one
               request of 16 tokens), and the prefill's attention through
               the port's flash_attention beside torch's
               scaled_dot_product_attention.  ``lm_swa:`` H2O-Danube-1.8B
               at full width, one request of 4160 tokens (past its 4096
               window) and 16 decode steps through the ring buffer, each
               step's logits against the full forward; ms a step
 12. lm_models the SSM, hybrid and encoder-decoder LMs, which run no
               hand-written kernel either (``kernel_launches=0``, counted
               from 0 over the phase), each at full width in bf16, seeded,
               through build_model and launch.serve's ``serve``, 8
               requests, 32 tokens each: ``lm_mamba2:`` Mamba2-2.7B (64
               layers, d_model 2560, state 128, 80 heads x 64) and
               ``lm_zamba2:`` Zamba2-2.7B (54 mamba layers, a shared MHA
               block every 6) on 128-token prompts; ``lm_whisper:``
               Whisper-medium (24 + 24 layers, d_model 1024) on seeded
               frames of its native 1500-frame window and 375-token
               prompts.  Each: prefill ms, decode ms a step beside the
               bytes bound of what a step moves (weights, the recurrent
               state read and written, the caches), tokens/s, peak MiB,
               the profiled step's kernels and idle share; decode against
               the full forward (Whisper: prefill + one step; Mamba2,
               Zamba2: every block's decode against its forward on the
               forward's own inputs, at full depth; end to end, token by
               token from an empty cache with the SSM state of a prefill
               against the decoded one, held at 2 Mamba2 layers and
               measured elsewhere beside the logits' one-ulp
               sensitivity: random SSM weights amplify rounding about
               1.2x a layer); a decode step under
               set_sync_debug_mode("error"); the card against the CPU at
               2 / 6 / 2 + 2 layers (Zamba2 block by block)
 13. lm_mesh   the LM stack's parallel pieces on one-process meshes,
               spoofed on the one card (real where the host has enough
               cards; each line's ``mesh:`` says which),
               which run no hand-written kernel either (counted from 0
               over the phase); each line counts the shard bodies that ran
               against shards x layers x calls.  ``lm_moe_ep:``
               Qwen3-MoE-235B-A22B at full width (128 experts top-8,
               expert FFN 1536) cut to 2 of 94 layers, served by
               launch.serve's ``serve(mesh=(2, 4))``, 32 experts a shard;
               ``lm_moe_tp:`` Mixtral-8x7B at full width cut to 2 of 32
               layers on a (1, 16) mesh, 896 of d_ff a shard; both 8 x 128
               prompt tokens, 32 tokens each, with layer 0's meshed MoE
               against the one-device moe_ffn in float32 (no drops), the
               combine's orders timed, prefill and decode profiled.
               ``lm_sp:`` InternLM2-1.8B at full width and depth through
               ``serve(mesh=(1, 4), sp=True)``, 40 cache slots a shard,
               every decode step against the un-meshed decode fed the same
               tokens, a step under set_sync_debug_mode("error").
               ``pipeline:`` 4 DeepSeek-67B layers at full width as 4
               stages, 6 microbatches of 2 x 256 tokens through
               ``pipeline_forward``, equal to ``sequential_reference``.
               Each also at smoke size on the card against the CPU
 14. lm_train  LM training through launch.train's ``train``, which runs no
               hand-written kernel either (counted from 0 over the
               phase).  ``lm_train:`` InternLM2-1.8B at full width and
               depth (float32 parameters, seeded; bf16 activations; every
               layer and q chunk rematerialised), 4 AdamW steps of 4 x 4096
               tokens (train_4k's sequence, its batch of 256 cut to 4), no
               checkpoint: step ms (median after one warm step), tokens/s,
               peak MiB, model FLOPs over the bf16 peak, a profiled step's
               kernels and idle share; then at 2 layers and seq 1024 the
               loss and every gradient with and without remat, equal bit
               for bit, and both peaks.  ``lm_train_100m:`` the twin of
               examples/train_lm.py --size 100m (12 x 768, GQA 12/4, vocab
               32000), 8 x 256 tokens, 200 steps, and a run stopped at 100
               and resumed from its checkpoint, equal bit for bit; the loss
               falls by a margin fixed on the CPU; ms a step, stragglers.
               ``lm_train_mesh:`` the smoke elastic restart (4, 2) -> (2, 2)
               on spoofed meshes, equal to an uninterrupted run; one smoke
               step on a spoofed (4, 2) mesh equal to the step on the card
               alone; and one Mixtral smoke step on (1, 2) (the meshed
               MoE), card against CPU
 15. dryrun    the dry-run tools (launch.dryrun, launch.hlo_flops), which
               launch no hand-written kernel either (counted from 0 over
               the phase).  ``dryrun:`` InternLM2-1.8B at full width cut
               to 2 layers: a training step, a prefill of 2 x 1024 tokens
               and one decode step, each counted on meta tensors and again
               on the card under the same counter, every count equal (the
               dry-run measures what the card runs).  ``dryrun_lm_train:``
               the ``lm_train:`` cell counted on meta at full depth beside
               phase 14's measured step and peak: counted FLOPs, model
               FLOPs (6 N D) and their share, the roofline terms on the
               H100's data-sheet rates, the counted peak (arguments plus
               live temporaries) against max_memory_allocated

then each phase's seconds (``timing:``), the card's name and power limit, one JSON line of kernel results, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; it also refuses to run with no
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100's data-sheet rates (dense, 700 W), kept with the dry-run's
    # roofline terms
    from repro_torch.launch.hlo_analysis import (BF16_FLOP_PER_S,
                                                 F32_FLOP_PER_S,
                                                 HBM_BYTES_PER_S,
                                                 TF32_FLOP_PER_S)
except ImportError:
    sys.exit(f"chip_smoke: {ROOT} is not a checkout of the repository "
             f"(src/repro_torch is missing)")
SEED = 0
N_REQUESTS = 8
N_STREAM = 32                # requests of the stream phase's arrival trace
LENGTHS = (8, 25)            # request lengths are drawn from this range
GAINS = (1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)
MIN_RATE = 0.02              # least spike rate the gain must give each layer
REPS = 200                   # launches a device or issue time is taken over
PRECISION_BUDGET = 0.05      # the reference precision bench's budget
SPIKIFY_WIDTHS = (2048, 8192)  # InternLM2-1.8B d_model, d_ff
SPIKIFY_TOKENS = 16
SPIKIFY_STEPS = (16, 64, 256)


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


def device_us(fn, kernel: str, reps: int = REPS) -> dict:
    """``fn``'s device time per call in µs, two ways: ``prof``, the mean
    duration of the kernels whose name holds ``kernel`` in a
    ``torch.profiler`` trace of ``reps`` calls (None if the trace holds
    none); ``events``, CUDA events around ``reps`` back-to-back calls, which
    equal the device time only while the device, not the host, is the
    slower side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.device_time_total for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name]
    return dict(prof=sum(durs) / len(durs) if durs else None,
                events=cuda_ms(fn, reps) * 1e3)


def issue_us(fn, reps: int = REPS) -> float:
    """Host µs per call of ``fn`` over ``reps`` calls issued without a sync
    (one sync after, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def lif_timing(cur: torch.Tensor, lif) -> dict:
    """lif_scan at ``cur``'s shape [B, T, n], in µs: the kernel's device
    time per launch (the bare C entry on a preallocated output), the
    host's issue time per ``ops.lif_scan`` call, and the launch floor, an
    empty kernel of the same grid timed the same way.  tools/
    torch_lif_bench.py also times an older checkout with it, whose entry
    takes no column tile and which has no empty kernel (floor None)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import lif_update as lu
    from repro_torch.kernels import ops
    b, t, n = cur.shape
    lib = _build.library("lif_update")
    tiled = "empty_launch" in _build.SIGNATURES["lif_update"]
    cols = lu.tile_cols(b, n, torch.cuda.get_device_properties(
        cur.device).multi_processor_count) if tiled else None
    shape = (b, t, n, cols) if tiled else (b, t, n)
    out = torch.empty_like(cur)
    consts = [ctypes.c_float(np.float32(x))
              for x in (lif.beta, lif.threshold, lif.v_reset)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def bare():
        _build.check(lib, lib.lif_scan_f32(
            cur.data_ptr(), None, None, out.data_ptr(), *shape, *consts,
            stream), "lif_update")

    def empty():
        _build.check(lib, lib.empty_launch(b * -(-n // cols), cols, stream),
                     "empty_launch")

    dev = device_us(bare, "lif_")
    floor = device_us(empty, "empty_kernel") if tiled else {}
    return dict(cols=cols, device_us=dev["prof"], device_event_us=dev["events"],
                issue_us=issue_us(lambda: ops.lif_scan(cur, lif)),
                floor_us=floor.get("prof"), floor_event_us=floor.get("events"))


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


def cifar_model(dev) -> dict:
    """The main path's model: the native-width CIFAR10-DVS MLP, seeded,
    pruned and scaled to fire through every layer, mapped onto Accel_2 and
    packed on ``dev`` on both routes, with the 8 requests it serves.
    Returns every piece by name, with the mapping and packing costs."""
    from repro_torch.configs.menage_paper import ACCEL_2, CIFAR_DATA, CIFAR_SNN
    from repro_torch.core.accelerator import map_model
    from repro_torch.engine import BucketPolicy, plan_batches

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
    return dict(streams=streams, policy=policy, plans=plans, big=big,
                x_big=x_big, ws=ws, gain=gain, mapped=mapped, map_s=map_s,
                dense=dense, pack_s=pack_s, pack_mib=pack_mib, packed=packed)


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

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [
        dict(name="event_synapse",
             source="src/repro_torch/kernels/csrc/event_synapse.cu",
             replaces="src/repro/kernels/event_synapse.py:49",
             ms=cuda_ms(lambda: ops.event_synapse(ev, dl.w_fused,
                                                  compacted=True)),
             plain_ms=cuda_ms(lambda: es.event_synapse_plain(ev, dl.w_fused),
                              reps=2),
             bound=(bytes_dense, flops),
             library_ms=cuda_ms(lambda: torch.matmul(spikes, dl.w_fused))),
        dict(name="event_synapse_packed",
             source="src/repro_torch/kernels/csrc/event_synapse.cu",
             replaces="src/repro/kernels/event_synapse.py:124",
             ms=cuda_ms(lambda: ops.event_synapse_packed(
                 ev, pl.w_packed, pl.scale_host, bits=pl.bits,
                 compacted=True)),
             plain_ms=cuda_ms(lambda: es.event_synapse_packed_plain(
                 ev, pl.w_packed, pl.scale, pl.bits), reps=2),
             bound=(bytes_packed, 2 * flops),
             library_ms=cuda_ms(lambda: torch.matmul(spikes, dl.w_fused))),
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
    rows.append(lif_row(c3, dense.lif, err["lif_update"]))
    packed_widths(ev, spikes, dl.n_src, n_dest, n_valid, n_rows_read)
    return rows


def lif_row(c3: torch.Tensor, lif, max_abs_err: float) -> dict:
    """The lif_update kernel's row at the input layer's currents ``c3``:
    ``ms`` is its device time per launch (profiler; CUDA events where the
    profiler saw no kernel), beside the host's issue time per call and the
    launch floor; then the same at [8, 32, 1024] on seeded currents,
    checked bit for bit against the plain version first."""
    from repro_torch.kernels import lif_update as lu
    from repro_torch.kernels import ops

    def timed(cur):
        t = lif_timing(cur, lif)
        dev = t["device_us"] if t["device_us"] is not None \
            else t["device_event_us"]
        floor = t["floor_us"] if t["floor_us"] is not None \
            else t["floor_event_us"]
        return t, dev / 1e3, floor / 1e3

    t16, ms, floor_ms = timed(c3)
    rng = np.random.default_rng(SEED + 7)
    c32 = torch.from_numpy(rng.normal(0.3, 0.6, (8, 32, 1024))
                           .astype(np.float32)).to(c3.device)
    require(torch.equal(ops.lif_scan(c32, lif), lu.lif_scan_plain(c32, lif)),
            "lif_scan at [8, 32, 1024]")
    t32, ms32, floor32 = timed(c32)
    row = dict(name="lif_update", route="cuda",
               source="src/repro_torch/kernels/csrc/lif_update.cu",
               replaces="src/repro/kernels/lif_update.py:32",
               ms=ms, issue_ms=t16["issue_us"] / 1e3, floor_ms=floor_ms,
               plain_ms=cuda_ms(lambda: lu.lif_scan_plain(c3, lif)),
               library_ms=None, max_abs_err=max_abs_err,
               **bound(2 * c3.numel() * 4, 4 * c3.numel()))
    r = lambda v: None if v is None else round(v, 5)  # noqa: E731
    log("kernel", name="lif_update", shape="x".join(map(str, c3.shape)),
        ms=r(ms), plain_ms=round(row["plain_ms"], 4),
        bound_ms=round(row["bound_ms"], 5), bound_by=row["bound_by"],
        library_ms=None, cols=t16["cols"], device_us=r(t16["device_us"]),
        device_event_us=r(t16["device_event_us"]),
        issue_us=r(t16["issue_us"]), floor_us=r(t16["floor_us"]),
        floor_event_us=r(t16["floor_event_us"]),
        at_8x32x1024=json.dumps({k: r(v) for k, v in t32.items()}),
        bound_ms_8x32x1024=round(bound(2 * c32.numel() * 4,
                                       4 * c32.numel())["bound_ms"], 5))
    return row


def phase_event_lists(dense, packed, spikes: torch.Tensor) -> dict:
    """Both event_synapse routes on event lists outside the MEM_E writer's
    layout, through the public ops: layer 2's real events (``spikes``
    [R, n_src]) spread out with a -1 after every entry and about a tenth
    of the entries masked to -1, so every row has interior -1s; each result
    bit for bit against the plain version on the same list (which adds the
    valid entries in list order) and against the kernel on the compacted
    list.  An unsorted row must raise ValueError."""
    from repro_torch.kernels import event_synapse as es
    from repro_torch.kernels import ops

    dl, pl = dense.layers[1], packed.layers[1]
    ev = ops.events_from_spikes(spikes, dl.n_src)
    r, e = ev.shape
    wide = torch.full((r, 2 * e), -1, dtype=torch.int32, device=ev.device)
    wide[:, ::2] = ev
    gen = torch.Generator(device=ev.device).manual_seed(SEED + 8)
    drop = torch.rand(wide.shape, generator=gen, device=ev.device) < 0.1
    wide = torch.where(drop, -1, wide)
    kept = es.compact_events(wide)
    routes = {
        "dense": (lambda v, **kw: ops.event_synapse(v, dl.w_fused, **kw),
                  lambda v: es.event_synapse_plain(v, dl.w_fused)),
        "packed": (lambda v, **kw: ops.event_synapse_packed(
            v, pl.w_packed, pl.scale, bits=pl.bits, **kw),
                   lambda v: es.event_synapse_packed_plain(
            v, pl.w_packed, pl.scale, pl.bits)),
    }
    interior = int(((wide[:, :-1] == -1) & (wide[:, 1:] >= 0)).sum())
    for name, (kernel, plain) in routes.items():
        got = kernel(wide)
        require(torch.equal(got, plain(wide)),
                f"{name} route on interior -1 lists equals its plain version")
        require(torch.equal(got, kernel(kept, compacted=True)),
                f"{name} route on interior -1 lists equals the compacted list")
        unsorted = ev.clone()
        unsorted[3, :2] = torch.tensor([5, 2], dtype=torch.int32)
        try:
            kernel(unsorted)
        except ValueError:
            pass
        else:
            raise SystemExit(f"FAILED: {name} route took an unsorted row")
    return dict(rows=r, width=2 * e, interior_gaps=interior,
                valid=int((wide >= 0).sum()), dense_equal=True,
                packed_equal=True, unsorted_refused=True)


def phase_sync_free(models: dict, x: torch.Tensor) -> dict:
    """One engine forward of each model under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the device; the routes' outputs equal."""
    from repro_torch.engine.batched_run import _forward_impl
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {name: _forward_impl(m, x, None) for name, m in models.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    first = next(iter(outs.values()))
    require(all(torch.equal(o[-1], first[-1]) for o in outs.values()),
            "sync-free forwards agree across routes")
    return dict(routes=",".join(outs), raised=False,
                out_spikes=int(first[-1].sum().item()))


def packed_widths(ev, spikes, n_src: int, n_dest: int, n_valid: int,
                  n_rows_read: int) -> None:
    """The packed kernel at the widths the packed route exists for, 4 and 2
    bits, on the input layer's real events: seeded codes from pack_signmag,
    bit-exact against the plain version, timed beside the library call on
    the same dequantised tile (made outside the timed window)."""
    from repro_torch.core.quant import pack_signmag, unpack_signmag
    from repro_torch.kernels import event_synapse as es
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 6)
    scale = 0.013
    out_bytes = ev.shape[0] * n_dest * 4
    for bits in (4, 2):
        qmax = 2 ** (bits - 1) - 1
        codes = rng.integers(-qmax, qmax + 1, (n_src, n_dest)).astype(np.int8)
        pk = torch.from_numpy(pack_signmag(codes, bits)).to(ev.device)
        got = ops.event_synapse_packed(ev, pk, scale, bits=bits)
        require(torch.equal(got, es.event_synapse_packed_plain(
            ev, pk, scale, bits)), f"event_synapse_packed at {bits} bits")
        tile = unpack_signmag(pk, bits).to(torch.float32) * scale
        b = bound(n_valid * 4 + n_rows_read * n_dest * bits // 8 + out_bytes,
                  2 * n_valid * n_dest)
        log("kernel", name="event_synapse_packed", bits=bits,
            ms=round(cuda_ms(lambda: ops.event_synapse_packed(
                ev, pk, scale, bits=bits, compacted=True)), 4),
            bound_ms=round(b["bound_ms"], 4), bound_by=b["bound_by"],
            library_ms=round(cuda_ms(lambda: torch.matmul(spikes, tile)), 4),
            shape=f"events[{ev.shape[0]},{ev.shape[1]}]x{n_src}x{n_dest}",
            max_abs_err=0.0)


def kernel_name(mangled: str) -> str:
    """``name<arg,...>`` of a mangled kernel symbol whose template
    arguments are integers, e.g. ``stream_kernel<8,32,32,256,4,512>``
    (enclosing namespaces dropped)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]
    if name is None:
        return mangled
    if mangled[pos:pos + 1] == "I":
        args = re.findall(r"Li(-?\d+)E", mangled[pos:].split("EE")[0] + "E")
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_registers(log_text: str) -> dict:
    """Registers per kernel from nvcc's ``-Xptxas -v`` report."""
    regs, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "Used " in ln and name:
            regs[name] = ln.split("Used ")[1].split(",")[0]
            name = None
    return regs


def bound(nbytes: float, nops: float, flop_per_s: float = F32_FLOP_PER_S
          ) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the rate of their type (float32
    outside the tensor cores unless another is named)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / flop_per_s * 1e3
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
                 # the least time of this product on the card, whatever
                 # computes it: the tensor cores at the TF32 rate, with the
                 # two MMAs a multiply-add that float32 accuracy needs
                 **bound(4 * m * k + k * n + 4 * m * n, 4 * m * k * n,
                         TF32_FLOP_PER_S))
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


class CountingSocket:
    """A client socket that counts the bytes it sends and receives."""

    def __init__(self, sock):
        self.sock, self.sent, self.received = sock, 0, 0

    def sendall(self, data) -> None:
        self.sock.sendall(data)
        self.sent += len(data)

    def recv(self, n: int) -> bytes:
        data = self.sock.recv(n)
        self.received += len(data)
        return data

    def __getattr__(self, name):
        return getattr(self.sock, name)


def socket_client(host: str, port: int, frames: list,
                  timeout: float) -> dict:
    """The socket phase's client: one thread sends the pre-encoded
    ``frames`` (request ids 0, 1, ... in order) while the calling thread
    reads the answers, each stamped on the host clock.  Returns the
    answers, the stamps, the wall seconds and the byte counts."""
    from repro_torch.launch.socket_serve import SpikeClient
    cli = SpikeClient(host, port, timeout=timeout)
    cli.sock = CountingSocket(cli.sock)
    cli._next_id = len(frames)
    sent_at, answered_at, failed = {}, {}, []

    def send_all():
        try:
            for req_id, frame in enumerate(frames):
                sent_at[req_id] = time.perf_counter()
                cli.sock.sendall(frame)
        except OSError as e:
            failed.append(e)

    sender = threading.Thread(target=send_all, name="socket-sender")
    t0 = time.perf_counter()
    sender.start()
    try:
        while len(answered_at) < len(frames) and not failed:
            cli._pump()
            now = time.perf_counter()
            for answers in (cli.results, cli.rejections, cli.admin_replies):
                for req_id in answers:
                    answered_at.setdefault(req_id, now)
        wall = time.perf_counter() - t0
    finally:
        sender.join(timeout)
        cli.close()
    require(not failed and not sender.is_alive(),
            f"socket sender finished: {failed}")
    return dict(results=cli.results, rejections=cli.rejections,
                admin=cli.admin_replies, sent_at=sent_at,
                answered_at=answered_at, wall=wall,
                bytes_sent=cli.sock.sent, bytes_received=cli.sock.received)


def phase_socket(dense, packed, mapped4, packed4, policy, cfgs) -> dict:
    """The wire front end at full width: a SpikeSocketServer on loopback
    with the CIFAR10-DVS MLP (dense route, the default tenant ``cifar``)
    and the 4-bit N-MNIST MLP (``nmnist4``) on the card, every bucket
    warmed first; its loop runs on serving_thread, which raises a fault
    of the loop here.  A bad-shape and an overlong request on a connection
    of their own must be rejected, and a corrupt connection dropped alone;
    then, counted, through socket_client: 32 CIFAR requests (the first
    a v1 frame), 4 N-MNIST requests, an ADMIN swap of ``cifar`` to the
    packed route of the same weights, 8 more CIFAR requests and ADMIN
    list / metrics / trace.  Best-effort slack."""
    from repro_torch.core.accelerator import run
    from repro_torch.engine import (METRIC_KEYS, FlightRecorder,
                                    ModelRegistry, run_bucketed)
    from repro_torch.engine import ingest
    from repro_torch.kernels import _build
    from repro_torch.launch.socket_serve import (SpikeClient,
                                                 SpikeSocketServer,
                                                 serving_thread)

    cifar_cfg, nmnist_cfg = cfgs
    rng = np.random.default_rng(SEED + 9)
    cifar = make_requests(rng, cifar_cfg, 32)
    nmnist = make_requests(rng, nmnist_cfg, 4)
    post = make_requests(rng, cifar_cfg, 8)
    # warm every bucket of every route the phase serves: first calls of a
    # shape make its input buffer and tensor maps
    for model, cfg in ((dense, cifar_cfg), (packed, cifar_cfg),
                       (packed4, nmnist_cfg)):
        warm = rate_map_streams(rng, cfg, [16] * 12 + [32] * 12)
        run_bucketed(model, warm, policy=policy, with_stats=False)

    # the counted traffic, encoded here; request ids follow the list
    frames: list[bytes] = []

    def add(encode, *args, **kw) -> int:
        frames.append(encode(len(frames), *args, **kw))
        return len(frames) - 1

    pre_ids = ([add(ingest.encode_request, cifar[0], version=1)]
               + [add(ingest.encode_request, s, model="cifar")
                  for s in cifar[1:]])
    nmnist_ids = [add(ingest.encode_request, s, model="nmnist4")
                  for s in nmnist]
    swap_id = add(ingest.encode_admin, {"op": "swap", "model": "cifar"})
    post_ids = [add(ingest.encode_request, s, model="cifar") for s in post]
    list_id = add(ingest.encode_admin, {"op": "list"})
    metrics_id = add(ingest.encode_admin, {"op": "metrics"})
    trace_id = add(ingest.encode_admin, {"op": "trace", "last": True})

    registry = ModelRegistry(device=dense.device)
    registry.register("cifar", dense, policy=policy)
    registry.register("nmnist4", packed4, policy=policy)
    tracer = FlightRecorder(keep_completed=256)
    srv = SpikeSocketServer(registry, model_factory=lambda spec: packed,
                            tracer=tracer)
    host, port = srv.address
    n_in = cifar_cfg.n_in
    torch.cuda.synchronize()
    _build.reset_launches()
    with serving_thread(srv):
        rej = SpikeClient(host, port, timeout=120)
        bad_shape = rej.send(np.zeros((8, n_in - 1), np.float32),
                             model="cifar")
        too_long = rej.send(
            np.zeros((srv.max_request_steps + 1, n_in), np.uint8),
            model="cifar")
        rej.recv_all()
        corrupt = SpikeClient(host, port, timeout=120)
        corrupt.sock.sendall(b"XX" + b"\x00" * 30)
        dropped = corrupt.sock.recv(1 << 10) == b""
        corrupt.close()
        # the rejected requests' connection stays open beside the counted
        # one: the corrupt connection is dropped alone
        got = socket_client(host, port, frames, 120.0)
        rej.close()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    results, admin = got["results"], got["admin"]

    require(dropped, "corrupt connection dropped")
    require("bad_shape" in rej.rejections.get(bad_shape, ""),
            f"bad-shape request rejected: {rej.rejections}")
    require("overlong" in rej.rejections.get(too_long, ""),
            f"overlong request rejected: {rej.rejections}")
    require(not rej.results and not got["rejections"],
            f"socket rejections {got['rejections']}, results {rej.results}")
    answered = [set(results), set(got["rejections"]), set(admin)]
    require(sum(map(len, answered)) == len(frames)
            and set().union(*answered) == set(range(len(frames))),
            "every socket request has exactly one answer")
    require(all(counts[k] > 0 for k in ("event_synapse",
                                         "event_synapse_packed",
                                         "lif_update")),
            f"socket launches {counts}")
    closed = run_bucketed(dense, cifar + post, policy=policy,
                          with_stats=False)
    cifar_ids = pre_ids + post_ids
    require(all(np.array_equal(results[r], c.out_spikes)
                for r, c in zip(cifar_ids, closed)),
            "socket CIFAR10-DVS results equal run_bucketed, both routes")
    require(all(np.array_equal(results[r], run(mapped4, s).out_spikes)
                for r, s in zip(nmnist_ids, nmnist)),
            "socket N-MNIST results equal the oracle")
    swap = admin[swap_id]
    require(swap == {"ok": True, "model": "cifar", "generation": 2},
            f"swap reply {swap}")
    lst = admin[list_id]
    require(lst.get("models") == {"cifar": 2, "nmnist4": 1},
            f"list reply {lst}")
    met = admin[metrics_id]
    require(met.get("ok") and set(met["metrics"]) == set(METRIC_KEYS),
            f"ADMIN metrics reply {sorted(met)}")
    trc = admin[trace_id]
    kinds = [sp["kind"] for sp in trc.get("trace", {}).get("spans", [])]
    require(trc.get("ok") and "admit" in kinds and "dispatch" in kinds,
            f"ADMIN trace spans {kinds}")
    snap = srv.server.metrics.snapshot()
    n_served = len(cifar_ids) + len(nmnist_ids)
    require(snap["hot_swaps"] == 1 and snap["completed"] == n_served,
            f"hot_swaps {snap['hot_swaps']}, completed {snap['completed']}")

    # where a CIFAR request's time goes, host clock: the decode of its
    # frame (timed here on the same bytes: FrameDecoder over 64 KiB chunks,
    # then decode_request); from its trace, the wait in the queue and the
    # engine call of its bucket (the dispatch span), which splits into the
    # padding (pad span), run_batched (the telemetry record's seconds:
    # upload, forward, download) and the rest of execute_plan
    decode_s = []
    for r in cifar_ids:
        t1 = time.perf_counter()
        dec = ingest.FrameDecoder()
        for off in range(0, len(frames[r]), 1 << 16):
            for f in dec.feed(frames[r][off:off + (1 << 16)]):
                ingest.decode_request(f.payload, f.version)
        decode_s.append(time.perf_counter() - t1)
    run_s = {rec["seq"]: rec["seconds"] for rec in srv.server.telemetry}
    split = {"queue": [], "pad": [], "dispatch": [], "run_batched": []}
    for tr in tracer.completed:
        if tr.model != "cifar":
            continue
        for sp in tr.spans:
            if sp.kind in split:
                split[sp.kind].append(sp.t1 - sp.t0)
            if sp.kind == "dispatch":
                split["run_batched"].append(run_s[sp.attrs["seq"]])
    lat = np.asarray([got["answered_at"][r] - got["sent_at"][r]
                      for r in cifar_ids + nmnist_ids])
    ms = lambda xs: round(float(np.mean(xs)) * 1e3, 4)  # noqa: E731
    pct = lambda q: round(float(np.percentile(lat, q)) * 1e3, 3)  # noqa: E731
    return dict(requests=n_served + 2, completed=snap["completed"],
                rejected=2, wall_s=round(got["wall"], 4),
                requests_per_s=round(snap["completed"] / got["wall"], 2),
                client_p50_ms=pct(50), client_p99_ms=pct(99),
                server_p50_ms=round(snap["recent_p50_latency_s"] * 1e3, 3),
                server_p99_ms=round(snap["recent_p99_latency_s"] * 1e3, 3),
                fill=round(snap["bucket_fill_ratio"], 4),
                dispatches=snap["dispatches"],
                cifar_decode_ms=ms(decode_s),
                cifar_queue_ms=ms(split["queue"]),
                cifar_engine_ms=ms(split["dispatch"]),
                cifar_pad_ms=ms(split["pad"]),
                cifar_run_batched_ms=ms(split["run_batched"]),
                bytes_sent=got["bytes_sent"],
                bytes_received=got["bytes_received"],
                launches=json.dumps(counts), hot_swaps=snap["hot_swaps"],
                generation=swap["generation"], dropped_alone=True,
                results_equal=True)


def phase_precision(policy, dev, card: str) -> dict:
    """Mixed widths on one served path: ``search_bits`` on the N-MNIST MLP
    at native width over a 25-step rate-map probe, host-timed; then the
    all-8, all-4, all-2 and searched configurations, each mapped, packed
    with ``packed_ops=True`` on the card and serving 8 rate-map requests
    through ``run_bucketed`` (warm, a timed pass without stats for
    events/s, then the counted pass with the counts at 0 just before it),
    every request bit-exact against the oracle.  The mixed configuration's
    counted pass is this phase's main path: it must launch the packed
    kernel at every width it holds, and hold a width below 8."""
    from repro_torch.configs.menage_paper import (ACCEL_1, NMNIST_DATA,
                                                  NMNIST_SNN)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.core.precision import (PARETO_POINT_KEYS, agreement,
                                            pareto_point, search_bits)
    from repro_torch.engine import run_bucketed
    from repro_torch.kernels import _build

    rng = np.random.default_rng(SEED + 10)
    lif = NMNIST_SNN.lif
    probe = rate_map_streams(rng, NMNIST_DATA, [NMNIST_SNN.num_steps])[0]
    streams = make_requests(rng, NMNIST_DATA, N_REQUESTS)
    ws = pruned_mlp(np.random.default_rng(SEED + 11), NMNIST_SNN.layer_sizes)
    gain = pick_gain(ws, torch.from_numpy(probe[None]).to(dev), lif)
    ws = [w * np.float32(gain) for w in ws]
    t0 = time.perf_counter()
    search = search_bits(ws, ACCEL_1, probe, lif=lif, budget=PRECISION_BUDGET)
    search_s = time.perf_counter() - t0
    mixed = search.per_layer_bits
    require(any(b < 8 for b in mixed),
            f"search_bits kept every layer at 8 bits ({mixed}): the mixed "
            f"path is not reached")
    n = len(ws)
    configs = [("w8", [8] * n), ("w4", [4] * n), ("w2", [2] * n),
               ("mixed", mixed)]
    n_events = int(sum(s.sum() for s in streams))
    base, points, launches = None, [], {}
    for label, bits in configs:
        mapped = map_model(ws, ACCEL_1, lif=lif, quant_bits=bits)
        require([l.bits for l in mapped.layers] == bits, f"{label} widths")
        probe_res = run(mapped, probe)
        base = probe_res.out_spikes if base is None else base
        packed = mapped.pack(packed_ops=True, device=dev)
        run_bucketed(packed, streams, policy=policy, with_stats=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_bucketed(packed, streams, policy=policy, with_stats=False)
        torch.cuda.synchronize()
        events_per_s = n_events / (time.perf_counter() - t0)
        res, counts, _ = drive(packed, streams, policy)
        by_bits = dict(_build.packed_launches_by_bits)
        require(all(by_bits[b] > 0 for b in set(bits))
                and counts["lif_update"] > 0,
                f"{label} launches {counts}, by width {by_bits}")
        for r, s in zip(res, streams):
            require(r.per_layer_bits == bits, f"{label} per_layer_bits "
                    f"{r.per_layer_bits}")
            require(oracle_equal(r, run(mapped, s)),
                    f"{label} request equals the oracle")
        pt = pareto_point(label, bits, probe_res, mapped,
                          agreement(probe_res.out_spikes, base),
                          events_per_s=events_per_s)
        require(tuple(pt) == PARETO_POINT_KEYS, "Pareto point keys")
        points.append(pt)
        launches[label] = dict(counts, by_bits=by_bits)
    return dict(card=json.dumps(card), model="nmnist", accel=ACCEL_1.name,
                sizes=list(NMNIST_SNN.layer_sizes), gain=gain,
                budget=PRECISION_BUDGET, search_s=round(search_s, 3),
                chosen_bits=mixed, agreement=search.agreement,
                energy_reduction=round(search.energy_reduction, 6),
                trials=len(search.history), requests=len(streams),
                input_events=n_events, oracle_equal=True,
                points=json.dumps(points),
                launches=json.dumps(launches["mixed"]),
                launches_by_config=json.dumps(launches))


def phase_spikify(dev, card: str) -> tuple[dict, dict]:
    """A transformer layer's FFN on the event kernel: ``spikified_ffn`` at
    InternLM2-1.8B's widths (a ReLU FFN, not that model's SwiGLU: only the
    widths are taken), seeded weights and tokens on the card, at each T of
    SPIKIFY_STEPS with the counts at 0 before the first and read after the
    last.  Then the T = 64 launch on its own frames (the generator
    reseeded) against the plain version, and the fold of its currents
    against the served result; its time, bound and the library matmul of
    the same frames.  Returns the line's fields and the kernels-line row."""
    from repro_torch.core.lif import rate_encode
    from repro_torch.core.spikify import rate_scale, spikified_ffn
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_synapse as es
    from repro_torch.kernels import ops

    d_model, d_ff = SPIKIFY_WIDTHS
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    w_in = torch.randn(d_model, d_ff, generator=gen, device=dev) \
        / float(np.sqrt(d_model))
    w_out = torch.randn(d_ff, d_model, generator=gen, device=dev) \
        / float(np.sqrt(d_ff))
    x = torch.randn(SPIKIFY_TOKENS, d_model, generator=gen, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = torch.relu(x @ w_in) @ w_out
    seeds = {t: SEED + 13 + t for t in SPIKIFY_STEPS}
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = {t: spikified_ffn(torch.Generator(device=dev).manual_seed(seeds[t]),
                             x, w_in, w_out, num_steps=t)
            for t in SPIKIFY_STEPS}
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(counts["event_synapse"] == len(SPIKIFY_STEPS),
            f"spikify launches {counts}")
    err = {t: (y - want).abs().mean().item() for t, (y, _) in outs.items()}
    corr = {t: float(np.corrcoef(y.cpu().numpy().ravel(),
                                 want.cpu().numpy().ravel())[0, 1])
            for t, (y, _) in outs.items()}
    require(all(np.isfinite(y.cpu().numpy()).all()
                and y.shape == want.shape for y, _ in outs.values()),
            "spikify outputs finite, [tokens, d_model]")
    lo, hi = SPIKIFY_STEPS[0], SPIKIFY_STEPS[-1]
    require(err[hi] < 0.5 * err[lo],
            f"mean abs error at T={hi} ({err[hi]}) below half of T={lo} "
            f"({err[lo]})")
    require(corr[64] > 0.9, f"correlation at T=64 {corr[64]}")

    # the T = 64 launch, on its own frames, against the plain version
    t = 64
    rates, x_max = rate_scale(torch.relu(x @ w_in))
    frames = rate_encode(rates, t, torch.Generator(device=dev)
                         .manual_seed(seeds[t]))
    spikes = frames.reshape(t * SPIKIFY_TOKENS, d_ff)
    ev = ops.events_from_spikes(spikes, d_ff)
    cur = ops.event_synapse(ev, w_out, compacted=True)
    plain = es.event_synapse_plain(ev, w_out)
    require(torch.equal(cur, plain), "spikify event_synapse equals plain")
    acc = torch.zeros(SPIKIFY_TOKENS, d_model, device=dev)
    for step in cur.reshape(t, SPIKIFY_TOKENS, d_model):
        acc = acc + step
    require(torch.equal(acc / torch.tensor(float(t), device=dev) * x_max,
                        outs[t][0]), "spikify T=64 result equals its frames")
    valid = ev >= 0
    n_valid = int(valid.sum())
    n_rows_read = int(torch.unique(ev[valid]).numel())
    r = ev.shape[0]
    row = dict(name="event_synapse", path="spikify", route="cuda",
               source="src/repro_torch/kernels/csrc/event_synapse.cu",
               replaces="src/repro/kernels/event_synapse.py:49",
               launches=counts["event_synapse"],
               max_abs_err=(cur - plain).abs().max().item(),
               ms=cuda_ms(lambda: ops.event_synapse(ev, w_out,
                                                    compacted=True)),
               plain_ms=cuda_ms(lambda: es.event_synapse_plain(ev, w_out),
                                reps=1),
               library_ms=cuda_ms(lambda: torch.matmul(spikes, w_out)),
               shape=f"events[{r},{ev.shape[1]}]x{d_ff}x{d_model}",
               **bound(n_valid * 4 + n_rows_read * d_model * 4
                       + r * d_model * 4, n_valid * d_model))
    fields = dict(card=json.dumps(card), d_model=d_model, d_ff=d_ff,
                  tokens=SPIKIFY_TOKENS, steps=list(SPIKIFY_STEPS),
                  event_fraction=json.dumps(
                      {t: round(float(st["event_fraction"]), 6)
                       for t, (_, st) in outs.items()}),
                  events=json.dumps({t: int(st["events"])
                                     for t, (_, st) in outs.items()}),
                  mean_abs_err=json.dumps({t: round(e, 6)
                                           for t, e in err.items()}),
                  corr=json.dumps({t: round(c, 6) for t, c in corr.items()}),
                  shape=row["shape"], valid_events=n_valid,
                  max_valid_per_row=int(valid.sum(dim=1).max()),
                  kernel_ms=round(row["ms"], 4),
                  bound_ms=round(row["bound_ms"], 4),
                  bound_by=row["bound_by"],
                  library_ms=round(row["library_ms"], 4),
                  plain_ms=round(row["plain_ms"], 4), plain_equal=True,
                  launches=json.dumps(counts))
    return fields, row


TRAIN_LR = 1e-3              # Table I's Adam rate (the SNNTrainConfig default)


def _quiet(msg: str) -> None:
    pass


def _held_out_accuracy(counts: np.ndarray, labels: np.ndarray) -> float:
    return float((counts.argmax(-1) == labels).mean())


def train_nmnist(dev, card: str) -> dict:
    """The paper's N-MNIST MLP at native width trained on the card: 40
    steps uninterrupted, and 20 + a resume to 40 through checkpoints,
    equal bit for bit; the first 3 losses against the CPU path from the
    same start; then pruned 50 %, quantized to 8 bits, mapped onto Accel_1
    and served on both event_synapse routes, every clip equal to the
    oracle."""
    import tempfile

    from repro_torch.configs.menage_paper import (ACCEL_1, NMNIST_DATA,
                                                  NMNIST_SNN)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.core.prune import prune_pytree
    from repro_torch.core.quant import quantize_pytree
    from repro_torch.data.events import event_batch_at, \
        synthetic_event_dataset
    from repro_torch.engine import (MLP_MODEL, BucketPolicy, SNNTrainConfig,
                                    run_bucketed, train_snn_model)
    from repro_torch.snn import snn_forward

    t_start = time.perf_counter()
    spikes, labels = synthetic_event_dataset(
        NMNIST_DATA, 32, np.random.default_rng(SEED + 20))
    n_test = len(labels) // 5
    train_x, train_y = spikes[n_test:], labels[n_test:]

    def train(steps, ckpt=None, device=dev):
        tc = SNNTrainConfig(steps=steps, lr=TRAIN_LR, grad_shards=8,
                            checkpoint_dir=ckpt, checkpoint_every=20,
                            log_every=1000)
        return train_snn_model(
            MLP_MODEL, NMNIST_SNN,
            lambda step: event_batch_at(train_x, train_y, 64, step), tc,
            key=torch.Generator().manual_seed(SEED + 21), device=device,
            log_fn=_quiet)

    params, hist = train(40)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        train(20, ckpt)
        resumed, hist_b = train(40, ckpt)
    require(hist_b["loss"] == hist["loss"][20:]
            and all(torch.equal(a, b) for a, b in zip(resumed, params)),
            "N-MNIST resume at step 20 equals the uninterrupted run bit for "
            "bit on the card")
    _, cpu_hist = train(3, device="cpu")
    require(np.allclose(hist["loss"][:3], cpu_hist["loss"], rtol=1e-4,
                        atol=0.0),
            f"first 3 losses {hist['loss'][:3]} equal the CPU path's "
            f"{cpu_hist['loss']} within rtol 1e-4")
    first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    require(np.isfinite(hist["loss"]).all() and last < first,
            f"N-MNIST loss falls: {first} -> {last}")

    pruned, _ = prune_pytree(params, 0.5)
    _, dq = quantize_pytree(pruned)
    test_x = torch.from_numpy(np.ascontiguousarray(
        spikes[:n_test].swapaxes(0, 1))).to(dev)
    counts_q = snn_forward(dq, test_x, NMNIST_SNN)[0].cpu().numpy()
    counts_f = snn_forward(params, test_x, NMNIST_SNN)[0].cpu().numpy()
    mapped = map_model([w.cpu().numpy() for w in dq], ACCEL_1,
                       lif=NMNIST_SNN.lif, quant_bits=8)
    clips = [spikes[i] for i in range(8)]
    policy = BucketPolicy(batch_sizes=(8,), time_steps=(NMNIST_SNN.num_steps,))
    oracles = [run(mapped, c) for c in clips]
    hw = {}
    for route, packed_ops in (("dense", False), ("packed", True)):
        res = run_bucketed(mapped.pack(packed_ops=packed_ops, device=dev),
                           clips, policy=policy)
        require(all(oracle_equal(r, o) for r, o in zip(res, oracles)),
                f"trained N-MNIST on the {route} route equals the oracle")
        hw[route] = np.stack([r.out_spikes.sum(axis=0) for r in res])
    require(np.array_equal(hw["dense"], hw["packed"]), "both routes agree")
    return dict(card=json.dumps(card), sizes=list(NMNIST_SNN.layer_sizes),
                params=sum(p.numel() for p in params), batch=64,
                grad_shards=8, steps=40, lr=TRAIN_LR,
                loss_first=round(hist["loss"][0], 6),
                loss_last=round(hist["loss"][-1], 6),
                acc_last=round(hist["acc"][-1], 4),
                cpu_losses=[round(x, 6) for x in cpu_hist["loss"]],
                card_losses=[round(x, 6) for x in hist["loss"][:3]],
                step_ms=round(1e3 * float(np.median(hist["step_time"][1:])),
                              3),
                resume_bit_exact=True, sparsity=0.5, quant_bits=8,
                accel=ACCEL_1.name,
                test_acc_float=_held_out_accuracy(counts_f, labels[:n_test]),
                test_acc_quant=_held_out_accuracy(counts_q, labels[:n_test]),
                clips=len(clips),
                hw_acc=_held_out_accuracy(hw["dense"], labels[:8]),
                quant_acc=_held_out_accuracy(counts_q[:8], labels[:8]),
                oracle_equal=True,
                seconds=round(time.perf_counter() - t_start, 2))


def train_cifar(dev, card: str) -> dict:
    """The paper's CIFAR10-DVS MLP at the sensor's native width (33.4 M
    parameters) trained on the card for 10 steps at batch 16; the loss,
    accuracy and gradients of step 1 against the CPU path from the same
    start; step time, samples/s and the peak device memory of the run.

    The loss is held at the CPU twins' rtol 1e-4.  The gradients at rtol
    1e-4 with a floor of 1e-4 max|g| per layer: the twins' floor of 1e-6
    max|g| is for 128-input sums, and the card and the CPU order the
    32768-input sums of layer 1 differently, a float32 error that grows
    between the square root and the whole of the 256 times longer sum (16x
    to 256x), and that the surrogate's slope carries into every layer's
    gradient."""
    from repro_torch.configs.menage_paper import CIFAR_DATA, CIFAR_SNN
    from repro_torch.data.events import event_batch_at, \
        synthetic_event_dataset
    from repro_torch.device import exact_float32
    from repro_torch.engine import MLP_MODEL, SNNTrainConfig, train_snn_model

    t_start = time.perf_counter()
    spikes, labels = synthetic_event_dataset(
        CIFAR_DATA, 4, np.random.default_rng(SEED + 22))

    def key():
        return torch.Generator().manual_seed(SEED + 23)

    def step1(device):
        """Loss, accuracy and gradients of step 1 on ``device``, and each
        layer's spikes and integrated membranes over that batch."""
        sp, lb = event_batch_at(spikes, labels, 16, 0)
        x = torch.from_numpy(np.ascontiguousarray(sp)).to(device)
        leaves = [p.requires_grad_(True)
                  for p in MLP_MODEL.init(key(), CIFAR_SNN, device)]
        with exact_float32(device):
            loss, acc = MLP_MODEL.loss(leaves, x,
                                       torch.from_numpy(lb).to(device),
                                       CIFAR_SNN)
            grads = torch.autograd.grad(loss, leaves)
            lif = CIFAR_SNN.lif
            beta, theta, reset = (torch.full((), c, device=device)
                                  for c in (lif.beta, lif.threshold,
                                            lif.v_reset))
            vs = [torch.zeros(x.shape[1], w.shape[1], device=device)
                  for w in leaves]
            s_l, v_l = [[] for _ in leaves], [[] for _ in leaves]
            with torch.no_grad():        # snn_forward's order of products
                for s_t in x:
                    for li, w in enumerate(leaves):
                        vi = beta * vs[li] + s_t @ w
                        s_t = (vi >= theta).to(torch.float32)
                        vs[li] = torch.where(s_t > 0, reset, vi)
                        s_l[li].append(s_t)
                        v_l[li].append(vi)
        return (loss.item(), acc.item(), [g.cpu().numpy() for g in grads],
                [torch.stack(a).cpu().numpy() for a in s_l],
                [torch.stack(a).cpu().numpy() for a in v_l])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2**20   # earlier phases'
    params, hist = train_snn_model(
        MLP_MODEL, CIFAR_SNN,
        lambda step: event_batch_at(spikes, labels, 16, step),
        SNNTrainConfig(steps=10, lr=TRAIN_LR, log_every=1000), key=key(),
        device=dev, log_fn=_quiet)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n_params = sum(p.numel() for p in params)
    require(n_params > 33_000_000, f"CIFAR10-DVS MLP has {n_params} params")
    require(np.isfinite(hist["loss"]).all() and all(
        bool(torch.isfinite(p).all()) for p in params),
        "CIFAR10-DVS losses and parameters finite")
    loss_c, acc_c, g_card, s_card, v_card = step1(dev)
    loss_h, acc_h, g_cpu, s_cpu, v_cpu = step1(torch.device("cpu"))
    flips = [int((a != b).sum()) for a, b in zip(s_card, s_cpu)]
    v_diff = max(float(np.abs(a - b).max()) for a, b in zip(v_card, v_cpu))
    require(loss_c == hist["loss"][0],
            "CIFAR10-DVS step 1 repeats bit for bit on the card")
    require(np.isclose(loss_c, loss_h, rtol=1e-4, atol=0.0)
            and acc_c == acc_h,
            f"CIFAR10-DVS step-1 loss {loss_c} equals the CPU path's "
            f"{loss_h} within rtol 1e-4")
    g_err, beyond_twin = [], []
    for li, (a, b) in enumerate(zip(g_card, g_cpu)):
        scale = float(np.abs(b).max())
        beyond_twin.append(int((np.abs(a - b) > 1e-4 * np.abs(b)
                                + 1e-6 * scale).sum()))
        require(np.allclose(a, b, rtol=1e-4, atol=1e-4 * scale),
                f"CIFAR10-DVS step-1 gradient of layer {li} equals the CPU "
                f"path's within rtol 1e-4, atol 1e-4 max|g|")
        g_err.append(float(np.abs(a - b).max()) / max(scale, 1e-30))
    step_s = float(np.median(hist["step_time"][1:]))
    split = train_step_breakdown(
        MLP_MODEL, CIFAR_SNN, params,
        event_batch_at(spikes, labels, 16, 10), dev)
    return dict(card=json.dumps(card), sizes=list(CIFAR_SNN.layer_sizes),
                params=n_params, batch=16, steps=10, lr=TRAIN_LR,
                clips=len(labels),
                losses=[round(x, 6) for x in hist["loss"]],
                cpu_loss_1=loss_h, card_loss_1=loss_c,
                grad_err_1=[f"{e:.3g}" for e in g_err],
                grad_beyond_twin_floor_1=beyond_twin,
                spike_flips_1=flips, membrane_diff_1=v_diff,
                step_ms=round(1e3 * step_s, 3),
                step_ms_all=[round(1e3 * x, 3) for x in hist["step_time"]],
                samples_per_s=round(16 / step_s, 2),
                peak_mib=round(peak_mib, 1), held_mib=round(held_mib, 1),
                tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                **split, seconds=round(time.perf_counter() - t_start, 2))


def train_step_breakdown(model, cfg, params, data, dev) -> dict:
    """Where one train step goes, as the loop runs it: the batch's upload,
    the step (forward, backward, Adam) and the one read-back of its
    metrics, each on the host clock around synchronised work, with the
    device's busy time and kernel count from the profiler over the same
    window (after one warm step from the same state)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import SNNTrainConfig, make_snn_train_step
    from repro_torch.engine.train_loop import init_train_state

    opt_cfg = SNNTrainConfig(lr=TRAIN_LR).adamw()
    step = make_snn_train_step(model, cfg, opt_cfg)
    state = init_train_state(None, params, opt_cfg).as_tree()
    sp, lb = (np.ascontiguousarray(x) for x in data)

    def upload():
        return {"spikes": torch.from_numpy(sp).to(dev),
                "labels": torch.from_numpy(lb).to(dev),
                "lr": torch.full((), TRAIN_LR, device=dev)}

    step(state, upload())
    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch = stage("h2d", upload)
        _, metrics = stage("step", lambda: step(state, batch))
        stage("metrics", lambda: torch.stack(
            [v.to(torch.float64) for v in metrics.values()]).tolist())
    device = device_ms_by_name(prof)
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "Memcpy" not in e.name and "Memset" not in e.name)
    wall, busy = sum(stages.values()), sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:5]
    return dict(split_ms=json.dumps({k: round(v, 3)
                                     for k, v in stages.items()}),
                split_wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
                device_idle_share=round(1 - busy / wall, 4),
                device_kernels=n_kernels,
                device_ms=json.dumps({k[:40]: round(v, 3) for k, v in top}))


def train_conv(dev, card: str) -> dict:
    """The reference's conv configuration (CIFAR_CONV) trained on the card
    for 20 steps at batch 32, pruned 50 %, lowered with ``layer_specs``,
    mapped onto Accel_2 and served on the dense kernel: every clip equal
    to the oracle."""
    from repro_torch.configs.menage_paper import (ACCEL_2, CIFAR_CONV,
                                                  CIFAR_CONV_DATA)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.core.prune import prune_pytree
    from repro_torch.data.events import event_batch_at, \
        synthetic_event_dataset
    from repro_torch.engine import (CONV_MODEL, BucketPolicy, SNNTrainConfig,
                                    run_bucketed, train_snn_model)
    from repro_torch.snn import layer_specs

    t_start = time.perf_counter()
    spikes, labels = synthetic_event_dataset(
        CIFAR_CONV_DATA, 16, np.random.default_rng(SEED + 24))
    n_test = len(labels) // 5
    params, hist = train_snn_model(
        CONV_MODEL, CIFAR_CONV,
        lambda step: event_batch_at(spikes[n_test:], labels[n_test:], 32,
                                    step),
        SNNTrainConfig(steps=20, lr=TRAIN_LR, grad_shards=8, log_every=1000),
        key=torch.Generator().manual_seed(SEED + 25), device=dev,
        log_fn=_quiet)
    require(np.isfinite(hist["loss"]).all(), "conv losses finite")
    pruned, _ = prune_pytree(params, 0.5)
    t0 = time.perf_counter()
    mapped = map_model(layer_specs(pruned, CIFAR_CONV), ACCEL_2,
                       lif=CIFAR_CONV.lif)
    map_s = time.perf_counter() - t0
    rounds = [len(layer.rounds) for layer in mapped.layers]
    require(max(rounds) > 1, f"a conv layer maps in more than one round "
            f"({rounds})")
    clips = [spikes[i] for i in range(4)]
    res = run_bucketed(mapped.pack(device=dev), clips,
                       policy=BucketPolicy(batch_sizes=(4,),
                                           time_steps=(CIFAR_CONV.num_steps,)))
    require(all(oracle_equal(r, run(mapped, c)) for r, c in zip(res, clips)),
            "trained conv SNN on the dense kernel equals the oracle")
    return dict(card=json.dumps(card), in_shape=list(CIFAR_CONV.in_shape),
                channels=list(CIFAR_CONV.conv_channels),
                params=sum(p.numel() for p in params), batch=32,
                grad_shards=8, steps=20, lr=TRAIN_LR,
                loss_first=round(hist["loss"][0], 6),
                loss_last=round(hist["loss"][-1], 6),
                step_ms=round(1e3 * float(np.median(hist["step_time"][1:])),
                              3),
                accel=ACCEL_2.name, layers=[type(s).__name__ for s in
                                            layer_specs(pruned, CIFAR_CONV)],
                rounds=rounds, map_s=round(map_s, 2), clips=len(clips),
                out_spikes=[int(r.out_spikes.sum()) for r in res],
                oracle_equal=True,
                seconds=round(time.perf_counter() - t_start, 2))


def train_sync_free(dev, card: str) -> dict:
    """One ``make_snn_train_step`` call of each family (the N-MNIST MLP,
    the conv SNN; ``grad_shards=8``) under
    ``torch.cuda.set_sync_debug_mode("error")``: the step reads nothing
    from the device."""
    from repro_torch.configs.menage_paper import (CIFAR_CONV, NMNIST_DATA,
                                                  NMNIST_SNN)
    from repro_torch.engine import (CONV_MODEL, MLP_MODEL, SNNTrainConfig,
                                    make_snn_train_step)
    from repro_torch.engine.train_loop import init_train_state

    opt_cfg = SNNTrainConfig().adamw()
    rng = np.random.default_rng(SEED + 26)
    out = {}
    for model, cfg, n_in in ((MLP_MODEL, NMNIST_SNN, NMNIST_DATA.n_in),
                             (CONV_MODEL, CIFAR_CONV, CIFAR_CONV.n_in)):
        params = model.init(torch.Generator().manual_seed(SEED + 27), cfg,
                            dev)
        state = init_train_state(None, params, opt_cfg).as_tree()
        step = make_snn_train_step(model, cfg, opt_cfg, grad_shards=8)
        batch = {"spikes": torch.from_numpy(
                     (rng.random((cfg.num_steps, 64, n_in)) < 0.05)
                     .astype(np.float32)).to(dev),
                 "labels": torch.from_numpy(rng.integers(0, 10, 64)).to(dev),
                 "lr": torch.full((), TRAIN_LR, device=dev)}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        err = None
        try:
            step(state, batch)
        except RuntimeError as e:
            err = str(e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(err is None, f"{model.name} train step waits on the device: "
                f"{err}")
        out[model.name] = True
    return dict(card=json.dumps(card), **out)


def phase_train(dev, card: str) -> tuple[list, dict]:
    """Phase 9: training on the card, then serving what it trained.  The
    launch counts go to 0 at the phase's start and are read at its end:
    training launches none of the hand-written kernels (it runs the plain
    ``lif_step`` under autograd), its serving ends launch all three event
    path kernels."""
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [("train_nmnist", train_nmnist(dev, card)),
             ("train_cifar", train_cifar(dev, card)),
             ("train_conv", train_conv(dev, card)),
             ("train_sync_free", train_sync_free(dev, card))]
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(all(counts[k] > 0 for k in ("event_synapse",
                                        "event_synapse_packed",
                                        "lif_update")),
            f"train phase launches {counts}")
    lines.append(("train", dict(card=json.dumps(card),
                                launches=json.dumps(counts),
                                seconds=round(time.perf_counter() - t_start,
                                              2))))
    return lines, counts


def sync_all() -> None:
    """Wait for every card (a real mesh spreads work over several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def smoke_mesh(dev):
    """The mesh phase's 2-way mesh: cuda:0 and cuda:1 where the host has
    two cards, else two spoofed shards of ``dev``."""
    from repro_torch.engine import snn_serve_mesh
    if torch.cuda.device_count() >= 2:
        return snn_serve_mesh(2)
    return snn_serve_mesh(device=dev, spoof=2)


def same_served(a, b) -> bool:
    """Two RequestResults, spikes, dispatch stats, utilization and
    overflow."""
    return (same_result(a, b) and len(a.util) == len(b.util)
            and all(np.array_equal(x, y) for x, y in zip(a.util, b.util))
            and all(np.array_equal(x, y)
                    for x, y in zip(a.overflow, b.overflow)))


def mesh_serve(mesh, mapped, routes: dict, streams, card: str
               ) -> tuple[dict, dict]:
    """The 8 requests on each route through ``run_bucketed(mesh=)`` with
    ``covering(n_shards=2)`` buckets, against the single-device call on the
    same buckets and, for the shortest request, the numpy oracle (about
    30 s of host time at native width); the
    launches of each counted call (each shard launches every layer, so a
    mesh call launches twice a single-device call's), and the wall time of
    each beside the other."""
    from repro_torch.core.accelerator import run
    from repro_torch.engine import BucketPolicy, plan_batches

    lengths = [s.shape[0] for s in streams]
    policy = BucketPolicy.covering(lengths, n_shards=mesh.size)
    plans = plan_batches(lengths, policy)
    require(all(p.b_pad % mesh.size == 0 for p in plans),
            f"every bucket splits over the mesh: {plans}")
    out = dict(card=json.dumps(card), policy=json.dumps(
        [list(policy.batch_sizes), list(policy.time_steps)]),
        plans=[(p.b_pad, p.t_pad) for p in plans])
    counts, served = {}, {}
    for route, model in routes.items():
        drive(model, streams, policy)                  # warm, one device
        one, c_one, s_one = drive(model, streams, policy)
        drive(model, streams, policy, mesh=mesh)       # warm, the mesh
        res, c_mesh, s_mesh = drive(model, streams, policy, mesh=mesh)
        synapse = ("event_synapse_packed" if route == "packed"
                   else "event_synapse")
        for k in (synapse, "lif_update"):
            require(c_one[k] > 0 and c_mesh[k] == mesh.size * c_one[k],
                    f"mesh {route} launches {c_mesh} are {mesh.size}x the "
                    f"single-device call's {c_one}")
        require(all(same_served(a, b) for a, b in zip(res, one)),
                f"mesh {route} route equals the single-device run")
        counts[route], served[route] = c_mesh, res
        out[f"{route}_launches"] = json.dumps(c_mesh)
        out[f"{route}_one_launches"] = json.dumps(c_one)
        out[f"{route}_mesh_s"] = round(s_mesh, 4)
        out[f"{route}_one_s"] = round(s_one, 4)
    short = sorted(range(len(streams)), key=lambda i: lengths[i])[:1]
    t0 = time.perf_counter()
    for i in short:
        oracle = run(mapped, streams[i])
        for route in routes:
            require(oracle_equal(served[route][i], oracle)
                    and all(np.array_equal(u, v) for u, v in
                            zip(served[route][i].util,
                                oracle.per_layer_util)),
                    f"mesh {route} request {i} equals the oracle")
    out.update(oracle_requests=short,
               oracle_s=round(time.perf_counter() - t0, 2),
               single_equal=True, oracle_equal=True)
    return out, counts


def mesh_chaos(mesh, dense, card: str) -> dict:
    """The chaos scenarios that script device loss, each replayed twice on
    the mesh: deterministic, the mesh 2 -> 1, every admitted request
    served, and every completed request equal to the single-device
    engine's run of it (through the scenario's noisy device instance where
    it serves one)."""
    from repro_torch.core.noise import (AnalogNoise, as_noise_key,
                                        perturb_packed)
    from repro_torch.engine import (SCENARIOS, run_bucketed, run_scenario,
                                    synth_arrival_trace)
    out = dict(card=json.dumps(card))
    for name in ("device_loss", "blackout"):
        sc = SCENARIOS[name]
        t0 = time.perf_counter()
        r1, rids, m1 = run_scenario(dense, sc, mesh=mesh)
        r2, _, m2 = run_scenario(dense, sc, mesh=mesh)
        wall = time.perf_counter() - t0
        require(m1 == m2 and r1.keys() == r2.keys() and all(
            np.array_equal(r1[k].out_spikes, r2[k].out_spikes) for k in r1),
            f"{name} replays deterministically on the mesh")
        require(m1["device_losses"] == len(sc.lose_devices)
                and (m1["mesh_size_start"], m1["mesh_size_end"])
                == (mesh.size, mesh.size - 1)
                and m1["served_all_admitted"],
                f"{name} recovers onto the shrunken mesh: {m1}")
        served = (perturb_packed(as_noise_key(sc.seed), dense,
                                 AnalogNoise(weight_sigma=sc.noise_sigma))
                  if sc.noise_sigma > 0 else dense)
        trace = synth_arrival_trace(
            sc.n_requests, dense.n_in, mode=sc.arrivals, rate=sc.rate,
            slack=sc.slack, t_lo=sc.t_lo, t_hi=sc.t_hi, seed=sc.seed)
        done = [(rid, s) for rid, (_, s, _) in zip(rids, trace)
                if rid is not None and rid in r1]
        require(len(done) == m1["completed"] > 0, f"{name} completed")
        one = run_bucketed(served, [s for _, s in done], with_stats=False)
        require(all(np.array_equal(r1[rid].out_spikes, o.out_spikes)
                    for (rid, _), o in zip(done, one)),
                f"{name}: every completed request equals a single-device "
                f"run")
        out[name] = json.dumps({
            k: m1[k] for k in ("requests", "completed", "dispatches",
                               "device_losses", "mesh_size_start",
                               "mesh_size_end", "served_all_admitted",
                               "shed", "rejected", "noise_probes")})
        out[f"{name}_wall_s"] = round(wall, 2)
    out.update(deterministic=True, single_equal=True)
    return out


def mesh_train(mesh, card: str) -> dict:
    """Data-parallel training on the mesh: the native-width CIFAR10-DVS MLP
    3 steps against 3 single-device steps at ``grad_shards=2`` (losses and
    parameters bit for bit, one mesh step under
    ``set_sync_debug_mode("error")``); CIFAR_CONV 2 steps on the mesh with
    a checkpoint, resumed on a 1-way mesh to step 4, bit for bit the
    uninterrupted 4 steps on the mesh; the trained conv SNN mapped onto
    Accel_2 and served across the mesh on the dense kernel against the
    oracle."""
    import tempfile

    from repro_torch.configs.menage_paper import (ACCEL_2, CIFAR_CONV,
                                                  CIFAR_CONV_DATA,
                                                  CIFAR_DATA, CIFAR_SNN)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.core.prune import prune_pytree
    from repro_torch.data.events import event_batch_at, \
        synthetic_event_dataset
    from repro_torch.engine import (CONV_MODEL, MLP_MODEL, BucketPolicy,
                                    SNNTrainConfig, make_snn_train_step,
                                    run_bucketed, shrink_mesh,
                                    train_snn_model)
    from repro_torch.engine.train_loop import init_train_state
    from repro_torch.snn import layer_specs

    home = mesh.devices[0]
    spikes, labels = synthetic_event_dataset(
        CIFAR_DATA, 4, np.random.default_rng(SEED + 30))

    def cifar(**kw):
        return train_snn_model(
            MLP_MODEL, CIFAR_SNN,
            lambda step: event_batch_at(spikes, labels, 16, step),
            SNNTrainConfig(steps=3, lr=TRAIN_LR, log_every=1000, **kw),
            key=torch.Generator().manual_seed(SEED + 31), device=home,
            log_fn=_quiet)

    t0 = time.perf_counter()
    p_mesh, h_mesh = cifar(mesh=mesh)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_one, h_one = cifar(grad_shards=mesh.size)
    one_s = time.perf_counter() - t0
    require(h_mesh["loss"] == h_one["loss"]
            and all(torch.equal(a, b) for a, b in zip(p_mesh, p_one)),
            "CIFAR10-DVS mesh training equals single-device training at "
            "grad_shards=2 bit for bit")
    opt_cfg = SNNTrainConfig(lr=TRAIN_LR).adamw()
    step = make_snn_train_step(MLP_MODEL, CIFAR_SNN, opt_cfg, mesh=mesh)
    state = init_train_state(None, p_mesh, opt_cfg).as_tree()
    sp, lb = event_batch_at(spikes, labels, 16, 3)
    batch = {"spikes": torch.from_numpy(np.ascontiguousarray(sp)).to(home),
             "labels": torch.from_numpy(lb).to(home),
             "lr": torch.full((), TRAIN_LR, device=home)}
    sync_all()
    torch.cuda.set_sync_debug_mode("error")
    err = None
    try:
        step(state, batch)
    except RuntimeError as e:
        err = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_all()
    require(err is None, f"the mesh train step waits on the device: {err}")

    cspikes, clabels = synthetic_event_dataset(
        CIFAR_CONV_DATA, 16, np.random.default_rng(SEED + 32))

    def conv(steps, m, ckpt):
        return train_snn_model(
            CONV_MODEL, CIFAR_CONV,
            lambda step: event_batch_at(cspikes, clabels, 32, step),
            SNNTrainConfig(steps=steps, lr=TRAIN_LR, mesh=m,
                           grad_shards=mesh.size, checkpoint_dir=ckpt,
                           checkpoint_every=2, log_every=1000),
            key=torch.Generator().manual_seed(SEED + 33), log_fn=_quiet)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ref, ref_hist = conv(4, mesh, f"{d}/ref")
        _, a_hist = conv(2, mesh, f"{d}/ab")
        resumed, b_hist = conv(4, shrink_mesh(mesh, 1), f"{d}/ab")
    require(a_hist["loss"] == ref_hist["loss"][:2]
            and b_hist["loss"] == ref_hist["loss"][2:]
            and all(torch.equal(a, b) for a, b in zip(resumed, ref)),
            "conv SNN checkpointed on the 2-way mesh and resumed on 1 equals "
            "the uninterrupted run bit for bit")
    pruned, _ = prune_pytree(ref, 0.5)
    mapped = map_model(layer_specs(pruned, CIFAR_CONV), ACCEL_2,
                       lif=CIFAR_CONV.lif)
    clips = [cspikes[i] for i in range(4)]
    res = run_bucketed(mapped.pack(device=home), clips, mesh=mesh,
                       policy=BucketPolicy(batch_sizes=(4,),
                                           time_steps=(CIFAR_CONV.num_steps,)))
    require(all(oracle_equal(r, run(mapped, c)) for r, c in zip(res, clips)),
            "trained conv SNN served across the mesh equals the oracle")
    return dict(card=json.dumps(card), cifar_steps=3, cifar_batch=16,
                grad_shards=mesh.size,
                cifar_losses=[round(x, 6) for x in h_mesh["loss"]],
                cifar_mesh_s=round(mesh_s, 3), cifar_one_s=round(one_s, 3),
                cifar_step_ms_mesh=round(
                    1e3 * float(np.median(h_mesh["step_time"])), 3),
                cifar_step_ms_one=round(
                    1e3 * float(np.median(h_one["step_time"])), 3),
                cifar_bit_exact=True, sync_free=True,
                conv_losses=[round(x, 6) for x in ref_hist["loss"]],
                conv_resume_bit_exact=True,
                conv_out_spikes=[int(r.out_spikes.sum()) for r in res],
                conv_oracle_equal=True)


def phase_mesh(dev, card: str, mapped, routes: dict, streams
               ) -> tuple[list, dict]:
    """Phase 10: the data-parallel mesh (2-way; real where there are two
    cards): the native-width CIFAR10-DVS MLP served on both routes, its
    device-loss chaos scenarios, and data-parallel training.  Returns the
    phase's lines and the launches of its main path (the dense and the
    packed serving runs, counted from 0 each)."""
    mesh = smoke_mesh(dev)
    lines = [("mesh", dict(devices=",".join(str(d) for d in mesh.devices),
                           real=mesh.real,
                           cards=torch.cuda.device_count()))]
    serve, counts = mesh_serve(mesh, mapped, routes, streams, card)
    lines.append(("mesh_serve", serve))
    lines.append(("mesh_chaos", mesh_chaos(mesh, routes["dense"], card)))
    lines.append(("mesh_train", mesh_train(mesh, card)))
    return lines, counts


# ------------------------------------------------------------- 11. the LM

LM_ARCH = "internlm2_1_8b"
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 128, 32
LM_CPU_LAYERS, LM_CPU_TOKENS = 2, 16
LM_SWA_ARCH = "h2o_danube_1_8b"
LM_SWA_PROMPT, LM_SWA_STEPS = 4160, 16      # past its 4096-token window
LM_ATOL, LM_RTOL = 0.15, 0.05   # bf16 logits: the reference's own tolerance


def lm_close(got: torch.Tensor, want: torch.Tensor, what: str,
             atol: float = LM_ATOL, hold: bool = True) -> float:
    """Require ``got`` finite, of ``want``'s shape and (where ``hold``)
    within the bf16 tolerance (``atol``, LM_RTOL) of it; the largest
    absolute difference."""
    g, w = got.float().cpu(), want.float().cpu()
    require(g.shape == w.shape and bool(torch.isfinite(g).all()),
            f"{what}: finite, shape {tuple(g.shape)} against "
            f"{tuple(w.shape)}")
    require(not hold or bool(torch.all((g - w).abs()
                                       <= atol + LM_RTOL * w.abs())),
            f"{what}: max abs diff {(g - w).abs().max().item()} outside "
            f"atol {atol} rtol {LM_RTOL}")
    return round((g - w).abs().max().item(), 6)


def lm_pad(cache: dict, n: int) -> dict:
    return {k: torch.nn.functional.pad(v, (0, 0, 0, n))
            for k, v in cache.items()}


def lm_attention(cfg, dev) -> dict:
    """The prefill's attention shape (LM_REQUESTS x LM_PROMPT, causal, GQA)
    on seeded bf16 q, k, v: the port's flash_attention (the served path,
    prefill's chunks) beside torch's scaled_dot_product_attention, with
    the bound of the work (q, k, v read and o written once; QK^T and PV
    over the causal half at the bf16 tensor-core rate)."""
    import torch.nn.functional as F
    from repro_torch.models.layers import flash_attention
    b, s, h, kh = LM_REQUESTS, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(b, s, kh, hd, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))

    def flash():
        return flash_attention(q, k, v, causal=True, q_chunk=512,
                               kv_chunk=512)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    err = (flash().float() - sdpa().float()).abs().max().item()
    require(err < 0.05, f"flash_attention against SDPA: {err}")
    nbytes = (2 * b * s * h * hd + 2 * b * s * kh * hd) * 2
    nops = 2 * 2 * b * h * hd * s * (s + 1) / 2
    return dict(attn_shape=f"q[{b},{s},{h},{hd}]kv[{b},{s},{kh},{hd}]",
                flash_ms=round(cuda_ms(flash), 4),
                sdpa_ms=round(cuda_ms(sdpa), 4),
                flash_vs_sdpa_max_abs=round(err, 6),
                attn_bound_ms=round(bound(nbytes, nops,
                                          BF16_FLOP_PER_S)["bound_ms"], 5))


def lm_decode_profile(step, step_ms: float, prefix: str = "decode",
                      warm: bool = True) -> dict:
    """One decode step (``step``, warmed up first where ``warm``) under the
    profiler: its kernels, their device time and the device's idle share
    of ``step_ms``, the step's time without the profiler (fields named
    after ``prefix``, for a call that is not a decode step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    device = device_ms_by_name(prof)
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    return {f"{prefix}_step_kernels": n,
            f"{prefix}_device_ms": round(busy, 4),
            f"{prefix}_idle_share": round(1 - busy / step_ms, 4),
            f"{prefix}_top_ms": json.dumps({k[:40]: round(v, 4)
                                            for k, v in top})}


def lm_card_vs_cpu(cfg, dev) -> dict:
    """InternLM2-1.8B at full width cut to LM_CPU_LAYERS layers, seeded on
    the card and copied to the CPU: one request of LM_CPU_TOKENS tokens,
    prefill logits and cache and one decode step on both, the card held to
    the port's CPU path."""
    import dataclasses
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import build_model
    cut = build_model(dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS))
    on_card = cut.init(seed=SEED + 41, dtype=torch.bfloat16, device=dev)
    on_cpu = tree_map(lambda t: t.cpu(), on_card)
    toks = torch.from_numpy(prompts_for(cfg, 1, LM_CPU_TOKENS + 1))
    out = {}
    for name, params in (("card", on_card), ("cpu", on_cpu)):
        d = params["embed"].device
        logits, cache = cut.prefill(params, {
            "tokens": toks[:, :LM_CPU_TOKENS].to(d)})
        step, cache = cut.decode(params, lm_pad(cache, 1), {
            "tokens": toks[:, LM_CPU_TOKENS].to(d), "pos": LM_CPU_TOKENS})
        out[name] = (logits, cache, step)
    (lc, cc, sc), (lh, ch, sh) = out["card"], out["cpu"]
    return dict(cpu_layers=LM_CPU_LAYERS, cpu_tokens=LM_CPU_TOKENS,
                cpu_prefill_max_abs=lm_close(lc, lh, "card prefill vs CPU"),
                cpu_cache_max_abs=max(lm_close(cc[k], ch[k],
                                               f"card cache {k} vs CPU")
                                      for k in ("k", "v")),
                cpu_decode_max_abs=lm_close(sc, sh, "card decode vs CPU"))


def phase_lm_serve(dev, card: str) -> dict:
    """Phase 11a: InternLM2-1.8B at full width in bf16 (seeded weights)
    through ``launch.serve.serve``: LM_REQUESTS prompts of LM_PROMPT tokens
    from the token pipeline, LM_GEN tokens each (one warm-up call of two
    tokens first).  Then prefill of one request against its full forward
    (decode of token S against ``transformer_logits`` over S + 1), a decode
    step under set_sync_debug_mode("error"), the card against the CPU at
    LM_CPU_LAYERS layers, and the prefill's attention beside SDPA.  Peak
    memory is the phase's own, above what earlier phases still hold."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.serve import prompts_for, serve
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    cfg = get_config(LM_ARCH)
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = bundle.init(seed=SEED + 42, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompts = torch.from_numpy(prompts_for(cfg, LM_REQUESTS,
                                           LM_PROMPT)).to(dev)
    serve(bundle, params, prompts, 2)
    out = serve(bundle, params, prompts, LM_GEN)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    toks = out["tokens"]
    require(toks.shape == (LM_REQUESTS, LM_GEN)
            and ((toks >= 0) & (toks < cfg.vocab_size)).all()
            and bool(torch.isfinite(out["logits"].float()).all()),
            f"served tokens {toks.shape}")
    steps = LM_GEN - 1
    decode_ms = out["decode_s"] / steps * 1e3
    # what a decode step must read: every weight but the embedding table,
    # of which only the batch's rows (the KV cache, at most 63 MB at the
    # horizon, left out)
    embed = params["embed"]
    step_bytes = (param_bytes - embed.numel() * embed.element_size()
                  + LM_REQUESTS * cfg.d_model * embed.element_size())

    # decode of token S against the full forward over S + 1
    one = torch.from_numpy(prompts_for(cfg, 1, LM_PROMPT + 1)).to(dev)
    with torch.no_grad():
        full, _ = T.transformer_logits(params, cfg, one)
        _, cache = T.transformer_prefill(params, cfg, one[:, :LM_PROMPT])
        got, cache = T.transformer_decode_step(
            params, cfg, lm_pad(cache, 1), one[:, LM_PROMPT], LM_PROMPT)
        fwd_err = lm_close(got, full[:, -1], "decode vs forward")
        spec, _ = bundle.cache_spec(LM_REQUESTS, LM_PROMPT + LM_GEN)
        fresh = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for k, s in spec.items()}
        def step():
            return bundle.decode(params, fresh, {"tokens": prompts[:, 0],
                                                 "pos": LM_PROMPT})

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prof = lm_decode_profile(step, decode_ms)
        del params, full, cache, fresh
        torch.cuda.empty_cache()
        cpu = lm_card_vs_cpu(cfg, dev)
        attn = lm_attention(cfg, dev)
    return dict(card=json.dumps(card), arch=LM_ARCH, params=n_params,
                param_gb=round(param_bytes / 1e9, 4), dtype="bfloat16",
                init_s=round(init_s, 3), requests=LM_REQUESTS,
                prompt=LM_PROMPT, gen=LM_GEN,
                prefill_ms=round(out["prefill_s"] * 1e3, 3),
                decode_ms_per_step=round(decode_ms, 4),
                decode_bound_ms=round(step_bytes / HBM_BYTES_PER_S * 1e3, 4),
                decode_bound_by="bytes",
                tokens_per_s=round(LM_REQUESTS * steps / out["decode_s"], 2),
                peak_mib=round(peak_mib, 1),
                sample=json.dumps(toks[0][:12].tolist()),
                decode_vs_forward_max_abs=fwd_err, sync_free=True, **prof,
                **cpu, **attn)


def phase_lm_swa(dev, card: str) -> dict:
    """Phase 11b: H2O-Danube-1.8B at full width in bf16 (seeded), one
    request of LM_SWA_PROMPT tokens, past its sliding window: prefill keeps
    a rolled ring buffer of `window` slots, then LM_SWA_STEPS decode steps;
    the prefill's and every step's logits against ``transformer_logits``
    over the whole sequence at the same position."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _fit, prompts_for
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    cfg = get_config(LM_SWA_ARCH)
    bundle = build_model(cfg)
    total = LM_SWA_PROMPT + LM_SWA_STEPS
    with torch.no_grad():
        params = bundle.init(seed=SEED + 43, dtype=torch.bfloat16,
                             device=dev)
        toks = torch.from_numpy(prompts_for(cfg, 1, total)).to(dev)
        full, _ = T.transformer_logits(params, cfg, toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = bundle.prefill(params, {
            "tokens": toks[:, :LM_SWA_PROMPT]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        require(cache["k"].shape[3] == cfg.window,
                f"ring buffer of {cfg.window} slots: {cache['k'].shape}")
        spec, _ = bundle.cache_spec(1, total)
        cache = {k: _fit(cache[k], s.shape) for k, s in spec.items()}
        steps = []
        t0 = time.perf_counter()
        for i in range(LM_SWA_STEPS):
            pos = LM_SWA_PROMPT + i
            logits, cache = bundle.decode(params, cache, {
                "tokens": toks[:, pos], "pos": pos})
            steps.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        pre_err = lm_close(last, full[:, LM_SWA_PROMPT - 1],
                           "SWA prefill vs forward")
        errs = [lm_close(s, full[:, LM_SWA_PROMPT + i],
                         f"SWA decode step {i} vs forward")
                for i, s in enumerate(steps)]
        del params, full, cache
        torch.cuda.empty_cache()
    return dict(card=json.dumps(card), arch=LM_SWA_ARCH, window=cfg.window,
                prompt=LM_SWA_PROMPT, steps=LM_SWA_STEPS,
                prefill_ms=round(prefill_s * 1e3, 3),
                decode_ms_per_step=round(decode_s / LM_SWA_STEPS * 1e3, 4),
                prefill_vs_forward_max_abs=pre_err,
                decode_vs_forward_max_abs=max(errs))


def phase_lm(dev, card: str) -> tuple[list, dict]:
    """Phase 11: the LM serving path, which runs no hand-written kernel:
    the launch counts are set to 0 before it and read after it."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [("lm_serve", phase_lm_serve(dev, card)),
             ("lm_swa", phase_lm_swa(dev, card))]
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(sum(counts.values()) == 0, f"the LM path launched {counts}")
    for _, fields in lines:
        fields["kernel_launches"] = 0
    return lines, counts


# ------------------------------- 12. the SSM, hybrid and encoder-decoder LMs

LM_FAMILIES = (("lm_mamba2", "mamba2_2_7b"), ("lm_zamba2", "zamba2_2_7b"),
               ("lm_whisper", "whisper_medium"))
LM_FWD_TOKENS = 16           # decode against the forward over 16 + 1 tokens
LM_SSM_ATOL = 0.2            # the reference's tolerance for SSM decode vs
                             # forward (test_mamba2_decode_matches_forward)
LM_CUT = {"mamba2_2_7b": dict(n_layers=2),
          "zamba2_2_7b": dict(n_layers=6),      # one group of hybrid_period
          "whisper_medium": dict(n_layers=2, n_encoder_layers=2)}


def lm_prompt_len(cfg) -> int:
    """LM_PROMPT tokens, or for Whisper the decoder length of its native
    30 s encoder window (``cross_len / decoder_ratio`` = 375)."""
    if cfg.family == "encdec":
        return cfg.cross_len // cfg.decoder_ratio
    return LM_PROMPT


def lm_frames(cfg, n: int, gen: torch.Generator):
    """``n`` requests of seeded encoder frames [n, cross_len, d_model]
    (float32) for Whisper, else None."""
    if cfg.family != "encdec":
        return None
    return torch.randn(n, cfg.cross_len, cfg.d_model, generator=gen,
                       device=gen.device)


def lm_step_bytes(cfg, params: dict, prompt: int) -> float:
    """The least bytes a decode step of LM_REQUESTS requests moves: every
    weight it reads, once (the shared Zamba2 block once, though it runs
    9 times); the embedding's batch rows, or for Whisper's tied head the
    whole table; the SSM and conv states read and written once; the
    attention caches' valid slots read once, at the decode loop's mean
    position; the cross cache whole."""
    from repro_torch.core.pytree import tree_leaves

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    b, hd = LM_REQUESTS, cfg.resolved_head_dim()
    valid = prompt + LM_GEN / 2
    if cfg.family == "encdec":
        dec = {k: v for k, v in params["decoder"].items()
               if k not in ("xwk", "xwv")}          # the cross cache holds them
        kv = 2 * cfg.n_layers * b * cfg.n_kv_heads * hd * 2
        return (nbytes(dec) + nbytes(params["embed"])
                + nbytes(params["ln_dec"]) + kv * (cfg.cross_len + valid))
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    state = cfg.n_layers * b * (h * cfg.ssm_head_dim * cfg.ssm_state * 4
                                + (cfg.ssm_conv_width - 1) * d_in * 2)
    total = (nbytes(params) - nbytes(params["embed"])
             + b * cfg.d_model * 2 + 2 * state)
    if cfg.family == "hybrid":
        n_outer = cfg.n_layers // cfg.hybrid_period
        total += 2 * n_outer * b * cfg.n_kv_heads * hd * 2 * valid
    return total


def lm_blocks(cfg, params) -> list:
    """Mamba2's or Zamba2's blocks in order, each ``("mamba", weights)`` or
    ``("shared", weights)``, the weights in bf16."""
    from repro_torch.models import zamba2 as Z
    from repro_torch.models.layers import bf16_layers
    from repro_torch.models.transformer import _layer
    if cfg.family == "ssm":
        layers = bf16_layers(params["layers"])
        return [("mamba", _layer(layers, i)) for i in range(cfg.n_layers)]
    shared = Z._shared(params)
    return [blk for group in Z._group_params(params, cfg)
            for blk in [("mamba", lp) for lp in group] + [("shared", shared)]]


def lm_block_run(kind: str, w: dict, cfg, x: torch.Tensor) -> tuple:
    """One block over ``x`` [1, n, d] both ways: its forward (the output at
    every token; a mamba block's final SSM state, else None) and its decode
    step token by token from empty states (the output at the last token;
    the final SSM state, else None)."""
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zamba2 as Z
    from repro_torch.models.transformer import (_cache_positions,
                                                _decode_position)
    b, n, _ = x.shape
    if kind == "mamba":
        d_in, h, nst, p = M._dims(cfg)
        y, state = M.mamba2_block(x, w, cfg)
        ssm = torch.zeros((b, h, p, nst), device=x.device)
        conv = torch.zeros((b, cfg.ssm_conv_width - 1, d_in),
                           dtype=torch.bfloat16, device=x.device)
        for t in range(n):
            yd = M.mamba2_block_decode(x[:, t], w, cfg, ssm, conv)
        return y, state, yd, ssm
    y, _, _ = Z._shared_block(x, w, cfg,
                              torch.arange(n, device=x.device).expand(b, n))
    ck = torch.zeros((b, cfg.n_kv_heads, n, cfg.resolved_head_dim()),
                     dtype=torch.bfloat16, device=x.device)
    cv = torch.zeros_like(ck)
    for t in range(n):
        pos, slot = _decode_position(cfg, t, ck)
        yd = Z._shared_block_decode(x[:, t], w, cfg, ck, cv, pos, slot,
                                    _cache_positions(cfg, n, pos))
    return y, None, yd, None


def lm_layerwise(cfg, params, toks: torch.Tensor, on_cpu=None) -> dict:
    """Mamba2, Zamba2 teacher-forced, block by block over ``toks`` [1, n]:
    each block runs on the forward's own inputs to it, so rounding does not
    compound over depth as it does end to end.  Held: each block's decode
    (token by token from empty states) against its forward, the output at
    the last token and the final SSM state (atol LM_SSM_ATOL for a mamba
    block, whose decode conv runs in float32 where the forward's runs in
    bf16; LM_ATOL for the shared block); with ``on_cpu``, the same
    parameters on the CPU, each block there against the card on the card's
    inputs, forward and decode (atol LM_ATOL)."""
    from repro_torch.models import mamba2 as M
    x = M._embed(params, cfg, toks)
    cpu_blocks = None if on_cpu is None else lm_blocks(cfg, on_cpu)
    errs: dict = {}

    def note(key, got, want, atol):
        errs[key] = max(errs.get(key, 0.0),
                        lm_close(got, want, f"{cfg.name} {key}", atol))

    for i, (kind, w) in enumerate(lm_blocks(cfg, params)):
        y, state, yd, sd = lm_block_run(kind, w, cfg, x)
        atol = LM_SSM_ATOL if kind == "mamba" else LM_ATOL
        note(f"layerwise_{kind}_decode_max_abs", yd, y[:, -1], atol)
        if state is not None:
            note("layerwise_state_max_abs", sd, state, atol)
        if cpu_blocks is not None:
            got = (y, state, yd, sd)
            want = lm_block_run(kind, cpu_blocks[i][1], cfg, x.cpu())
            for name, g, h in zip(("out", "state", "decode", "decode_state"),
                                  got, want):
                if g is not None:
                    note(f"cpu_block_{name}_max_abs", g, h, LM_ATOL)
        x = y
    return errs


def lm_decode_vs_forward(bundle, params, toks, hold: bool) -> dict:
    """Mamba2, Zamba2 end to end: ``toks`` [1, n + 1] decoded one by one
    from an empty cache against ``*_logits`` at the last position, and the
    SSM state a prefill of n tokens leaves against the state the first n
    decode steps leave (the prefill's conv tail is zeros by design, so it
    is left out and checked to be zeros).  Held at LM_SSM_ATOL (and
    LM_RTOL) where ``hold``, else only measured.  Beside them, the
    yardstick of what rounding alone does: the forward's logits with every
    embedding entry moved by one bf16 ulp, against the unmoved ones."""
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zamba2 as Z
    cfg = bundle.cfg
    n = toks.shape[1] - 1
    logits_of = M.mamba2_logits if cfg.family == "ssm" else Z.zamba2_logits
    full = logits_of(params, cfg, toks)[:, -1]
    moved = dict(params, embed=torch.nextafter(
        params["embed"], torch.full_like(params["embed"], math.inf)))
    ulp = logits_of(moved, cfg, toks)[:, -1]
    del moved
    sensitivity = round((ulp.float() - full.float()).abs().max().item(), 6)
    spec, _ = bundle.cache_spec(1, n + 1)
    cache = {k: torch.zeros(sp.shape, dtype=sp.dtype, device=toks.device)
             for k, sp in spec.items()}
    for t in range(n + 1):
        if t == n:
            decoded = cache["ssm"].clone()
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t], "pos": t})
    _, pre = bundle.prefill(params, {"tokens": toks[:, :n]})
    require(not bool(pre["conv"].any()), "prefill's conv tail is zeros")
    return dict(
        decode_vs_forward_max_abs=lm_close(
            logits, full, f"{cfg.name} decode vs forward", LM_SSM_ATOL,
            hold),
        prefill_state_vs_decode_max_abs=lm_close(
            pre["ssm"], decoded, f"{cfg.name} prefill state vs decode",
            LM_SSM_ATOL, hold),
        forward_ulp_sensitivity_max_abs=sensitivity)


def lm_family_vs_forward(bundle, params, prompts, frames) -> dict:
    """Each family's decode against its full forward at full width and
    depth, one request.  Whisper: prefill of the whole prompt, then one
    decode step, against ``whisper_decoder_logits`` over one token more
    (held).  Mamba2, Zamba2 over LM_FWD_TOKENS + 1 tokens: the
    teacher-forced layerwise check (held) and the end-to-end comparison
    (measured: on these random weights a rounding difference grows about
    1.2x a layer, so at 64 layers decode and forward decorrelate; the
    end-to-end check is held at LM_CUT's depth, in
    :func:`lm_family_card_vs_cpu`)."""
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import whisper as W
    cfg = bundle.cfg
    dev = prompts.device
    if cfg.family == "encdec":
        s = prompts.shape[1]
        one = torch.from_numpy(prompts_for(cfg, 1, s + 1)).to(dev)
        enc = W.whisper_encode(params, cfg, frames[:1])
        full = W.whisper_decoder_logits(params, cfg, one, enc)[:, -1]
        _, cache = W.whisper_prefill(params, cfg, frames[:1], one[:, :s])
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
                 if k in ("k", "v") else v for k, v in cache.items()}
        got, _ = W.whisper_decode_step(params, cfg, cache, one[:, s], s)
        return dict(decode_vs_forward_max_abs=lm_close(
            got, full, "whisper decode vs forward"))
    toks = prompts[:1, :LM_FWD_TOKENS + 1]
    out = lm_layerwise(cfg, params, toks)
    e2e = lm_decode_vs_forward(bundle, params, toks, hold=False)
    out.update({f"full_depth_{k}": v for k, v in e2e.items()})
    return out


def lm_family_card_vs_cpu(arch: str, cfg, dev, seed: int) -> dict:
    """The configuration at full width cut to LM_CUT's depth, seeded on the
    card and copied to the CPU: one request of LM_CPU_TOKENS tokens (and,
    for Whisper, its cross_len seeded frames), the prefill's logits and
    every cache entry, then one decode step's logits and every entry of the
    cache it leaves, the card against the port's CPU path.  For Mamba2 and
    Zamba2 also decode against the forward end to end at this depth, on
    the card (:func:`lm_decode_vs_forward`), and both checks block by
    block (:func:`lm_layerwise`, held).  The end-to-end checks are held
    for Mamba2 at 2 layers, the depth of the reference's own test, and
    for Whisper; for Zamba2 they are measured, as its 6 layers already
    amplify rounding past the tolerance (``cut_forward_ulp_sensitivity``
    shows by how much one ulp moves the forward)."""
    import dataclasses
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.serve import _fit, prompts_for
    from repro_torch.models import build_model
    cut = build_model(dataclasses.replace(cfg, **LM_CUT[arch]))
    on_card = cut.init(seed=seed, dtype=torch.bfloat16, device=dev)
    on_cpu = tree_map(lambda t: t.cpu(), on_card)
    toks = torch.from_numpy(prompts_for(cfg, 1, LM_CPU_TOKENS + 1))
    frames = lm_frames(cfg, 1, torch.Generator(device="cpu").manual_seed(
        seed))
    spec, _ = cut.cache_spec(1, LM_CPU_TOKENS + 1)
    out = {}
    for name, params in (("card", on_card), ("cpu", on_cpu)):
        d = params["embed"].device
        batch = {"tokens": toks[:, :LM_CPU_TOKENS].to(d)}
        if frames is not None:
            batch["frames"] = frames.to(d)
        logits, cache = cut.prefill(params, batch)
        pre = {k: v.clone() for k, v in cache.items()}
        cache = {k: _fit(cache[k], sp.shape) for k, sp in spec.items()}
        step, cache = cut.decode(params, cache, {
            "tokens": toks[:, LM_CPU_TOKENS].to(d), "pos": LM_CPU_TOKENS})
        out[name] = (logits, pre, step, cache)
    (lc, pc, sc, cc), (lh, ph, sh, ch) = out["card"], out["cpu"]
    hold = cfg.family != "hybrid"
    fields = dict(cpu_layers=json.dumps(LM_CUT[arch]),
                  cpu_tokens=LM_CPU_TOKENS)
    if cfg.family != "encdec":
        toks_card = toks[:, :LM_FWD_TOKENS + 1].to(dev)
        fields.update({f"cut_{k}": v for k, v in {
            **lm_decode_vs_forward(cut, on_card, toks_card, hold),
            **lm_layerwise(cut.cfg, on_card, toks_card, on_cpu)}.items()})
    return dict(
        **fields,
        cpu_prefill_max_abs=lm_close(lc, lh, "card prefill vs CPU",
                                     hold=hold),
        cpu_cache_max_abs=max(lm_close(pc[k], ph[k], f"card cache {k} vs CPU",
                                       hold=hold) for k in pc),
        cpu_decode_max_abs=lm_close(sc, sh, "card decode vs CPU", hold=hold),
        cpu_decode_cache_max_abs=max(
            lm_close(cc[k], ch[k], f"card decoded cache {k} vs CPU",
                     hold=hold) for k in cc))


def phase_lm_family(arch: str, dev, card: str, seed: int) -> dict:
    """Phase 12, one family: ``arch`` at full width in bf16 (seeded)
    through ``launch.serve.serve``: LM_REQUESTS prompts from the token
    pipeline (Whisper: 375-token prompts and seeded frames of its 1500-frame
    window), LM_GEN tokens each, one warm-up call of two tokens first.
    Then the decode step's bytes bound, decode against the full forward
    (:func:`lm_family_vs_forward`), a decode step under
    set_sync_debug_mode("error") and under the profiler, and the card
    against the CPU at LM_CUT's depth.  Peak memory is the family's own."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.serve import prompts_for, serve
    from repro_torch.models import build_model
    cfg = get_config(arch)
    bundle = build_model(cfg)
    prompt = lm_prompt_len(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        params = bundle.init(seed=seed, dtype=torch.bfloat16, device=dev)
        frames = lm_frames(cfg, LM_REQUESTS,
                           torch.Generator(device=dev).manual_seed(seed))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompts = torch.from_numpy(prompts_for(cfg, LM_REQUESTS,
                                           prompt)).to(dev)
    serve(bundle, params, prompts, 2, frames)
    out = serve(bundle, params, prompts, LM_GEN, frames)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    toks = out["tokens"]
    require(toks.shape == (LM_REQUESTS, LM_GEN)
            and ((toks >= 0) & (toks < cfg.vocab_size)).all()
            and bool(torch.isfinite(out["logits"].float()).all()),
            f"{arch} served tokens {toks.shape}")
    steps = LM_GEN - 1
    decode_ms = out["decode_s"] / steps * 1e3
    prefill_ms = out["prefill_s"] * 1e3
    tokens_per_s = LM_REQUESTS * steps / out["decode_s"]
    # the weight matmuls of a step (the embedding lookup does none; Whisper's
    # tied head is a matmul, its cross projections xwk / xwv are not run)
    step_ops = 2 * LM_REQUESTS * n_params
    if cfg.family == "encdec":
        step_ops = 2 * LM_REQUESTS * (
            sum(v.numel() for k, v in params["decoder"].items()
                if k not in ("xwk", "xwv")) + params["embed"].numel())
    else:
        step_ops -= 2 * LM_REQUESTS * params["embed"].numel()
    lim = bound(lm_step_bytes(cfg, params, prompt), step_ops,
                BF16_FLOP_PER_S)
    with torch.no_grad():
        fwd = lm_family_vs_forward(bundle, params, prompts, frames)
        spec, _ = bundle.cache_spec(LM_REQUESTS, prompt + LM_GEN)
        fresh = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for k, s in spec.items()}

        def step():
            return bundle.decode(params, fresh, {"tokens": prompts[:, 0],
                                                 "pos": prompt})

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prof = lm_decode_profile(step, decode_ms)
        del params, fresh, frames, out
        torch.cuda.empty_cache()
        cpu = lm_family_card_vs_cpu(arch, cfg, dev, seed + 1)
    return dict(card=json.dumps(card), arch=arch, params=n_params,
                param_gb=round(param_bytes / 1e9, 4), dtype="bfloat16",
                requests=LM_REQUESTS, prompt=prompt, gen=LM_GEN,
                prefill_ms=round(prefill_ms, 3),
                decode_ms_per_step=round(decode_ms, 4),
                decode_bound_ms=round(lim["bound_ms"], 4),
                decode_bound_by=lim["bound_by"],
                tokens_per_s=round(tokens_per_s, 2),
                peak_mib=round(peak_mib, 1),
                sample=json.dumps(toks[0][:12].tolist()), **fwd,
                sync_free=True, **prof, **cpu)


def phase_lm_models(dev, card: str) -> tuple[list, dict]:
    """Phase 12: Mamba2-2.7B, Zamba2-2.7B and Whisper-medium served at full
    width, which runs no hand-written kernel: the launch counts are set to
    0 before the phase and read after it."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [(name, phase_lm_family(arch, dev, card, SEED + 50 + 2 * i))
             for i, (name, arch) in enumerate(LM_FAMILIES)]
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(sum(counts.values()) == 0, f"the LM families launched {counts}")
    for _, fields in lines:
        fields["kernel_launches"] = 0
    return lines, counts


# ------------------------------------- 13. the LM on a one-process mesh

MESH_MOE = (("lm_moe_ep", "qwen3_moe_235b_a22b", (2, 4)),
            ("lm_moe_tp", "mixtral_8x7b", (1, 16)))
MESH_MOE_LAYERS = 2          # of 94 / 32: what one card holds at full width
# (the meshes are real where the host has enough cards, else spoofed)
MESH_SP_ARCH, MESH_SP_SHAPE = "internlm2_1_8b", (1, 4)
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_SEQ = (
    "deepseek_67b", 4, 6, 2, 256)
# the reference's test_moe tolerance; its atol taken relative to the
# output's scale (the full-width outputs are about 0.1, its test's 1)
MOE_ATOL_FRAC, MOE_RTOL = 5e-5, 1e-3


def lm_mesh(shape, axes, dev):
    """``shape`` over ``axes``: the first cards where the host has enough
    of them, else spoofed shards of ``dev``; and the fields that say
    which."""
    from repro_torch.launch.mesh import make_mesh
    n = math.prod(shape)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        mesh = make_mesh(shape, axes, device="cuda")
    else:
        mesh = make_mesh(shape, axes, device=dev, spoof=n)
    return mesh, dict(mesh="real" if mesh.real else "spoofed",
                      mesh_shape=json.dumps(mesh.shape),
                      mesh_device=",".join(sorted({str(d) for d in
                                                  mesh.devices})))


def lm_moe_check(cfg, params, mesh) -> dict:
    """Layer 0's MoE at full width on the card, ``moe_ffn_sharded`` on
    ``mesh`` against the card's one-device ``moe_ffn``, both at
    ``capacity_factor = E`` (no drops), in float32 (the layer's bf16
    weights widened, exactly; LM_REQUESTS x LM_PROMPT seeded tokens; TF32
    off): within MOE_ATOL_FRAC of the output's scale plus MOE_RTOL; the
    meshed MoE run twice, bit for bit."""
    from repro_torch.device import exact_float32
    from repro_torch.models.transformer import moe_ffn
    from repro_torch.parallel.moe import moe_ffn_sharded
    dev = mesh.devices[0]
    lp = {k: params["layers"][k][0].float()
          for k in ("router", "we_gate", "we_up", "we_down")}
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    x = torch.randn(LM_REQUESTS, LM_PROMPT, cfg.d_model, generator=gen,
                    device=dev)
    e = float(cfg.n_experts)
    with torch.no_grad(), exact_float32(dev):
        want, aux_w = moe_ffn(x, lp, cfg, capacity_factor=e)
        got, aux_g = moe_ffn_sharded(x, lp, cfg, mesh, capacity_factor=e)
        again, _ = moe_ffn_sharded(x, lp, cfg, mesh, capacity_factor=e)
    scale = want.abs().max().item()
    err = (got - want).abs()
    require(bool((err <= MOE_ATOL_FRAC * scale
                  + MOE_RTOL * want.abs()).all()),
            f"{cfg.name} meshed MoE against moe_ffn: max abs "
            f"{err.max().item()} at scale {scale}")
    require(torch.equal(got, again), f"{cfg.name} meshed MoE repeats")
    return dict(moe_check_max_abs=err.max().item(), moe_check_scale=scale,
                moe_check_tol=f"atol {MOE_ATOL_FRAC} x scale + rtol "
                              f"{MOE_RTOL}",
                moe_check_aux=round(aux_g.item(), 6),
                moe_check_aux_one_device=round(aux_w.item(), 6),
                moe_repeats=True)


def lm_combine_probe(dev, t: int, k: int, d: int, e: int) -> dict:
    """The local MoE's combine at one shard's shape (t tokens, k float32
    terms of width d each, experts drawn from e): the expert-ordered sum it
    runs (``combine``) beside a rank-ordered sum and the atomic
    ``index_add_`` the one-device ``moe_ffn`` uses; each one's ms, whether
    it repeats bit for bit over 3 runs, and the largest difference of the
    two fixed orders."""
    from repro_torch.parallel.moe import combine
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    eff = torch.rand(t, e, generator=gen, device=dev).topk(k, dim=1).indices
    order = torch.argsort(eff.reshape(-1), stable=True)
    contrib = torch.randn(t * k, d, generator=gen, device=dev)

    def expert_order():
        return combine(contrib, order, eff)

    def rank_order():
        terms = torch.empty_like(contrib).index_copy_(0, order, contrib)
        terms = terms.view(t, k, d)
        y = terms[:, 0]
        for j in range(1, k):
            y = y + terms[:, j]
        return y

    def index_add():
        return torch.zeros(t, d, device=dev).index_add_(0, order // k,
                                                        contrib)

    out = {}
    for name, fn in (("expert_order", expert_order),
                     ("rank_order", rank_order), ("index_add", index_add)):
        runs = [fn() for _ in range(3)]
        out[f"combine_{name}_repeats"] = all(torch.equal(runs[0], r)
                                             for r in runs[1:])
        out[f"combine_{name}_ms"] = round(cuda_ms(fn), 4)
    require(out["combine_expert_order_repeats"], "combine repeats")
    out["combine_orders_max_abs"] = (expert_order()
                                     - rank_order()).abs().max().item()
    out["combine_shape"] = f"t={t},k={k},d={d}"
    return out


def lm_mesh_card_vs_cpu(arch: str, shape, dev, seed: int,
                        sp: bool = False) -> dict:
    """The smoke configuration on spoofed meshes of ``shape`` on the card
    and on the CPU, seeded on the CPU and copied: prefill of 4 requests of
    LM_CPU_TOKENS tokens under the decode rules (the MoE sharded), then one
    decode step (with ``sp``, under the SP rules, through the SP attention,
    the horizon a multiple of the model axis); logits and caches, card
    against CPU, and the same shard bodies run on both."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.serve import _fit, prompts_for
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as PM
    from repro_torch.parallel.decode import make_sp_attention
    from repro_torch.parallel.sharding import (DECODE_RULES, DECODE_RULES_SP,
                                               activate)
    cfg = get_smoke_config(arch)
    bundle = build_model(cfg)
    on_cpu = bundle.init(seed=seed, dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(prompts_for(cfg, 4, LM_CPU_TOKENS + 1))
    spec, _ = bundle.cache_spec(4, LM_CPU_TOKENS + shape[1])
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = tree_map(lambda t: t.to(d), on_cpu)
        mesh, _ = lm_mesh(shape, ("data", "model"), d)
        kw = {"attn_impl": make_sp_attention(mesh)} if sp else {}
        PM.reset_body_runs()
        with torch.no_grad(), activate(mesh, DECODE_RULES_SP if sp
                                       else DECODE_RULES):
            logits, cache = bundle.prefill(params, {
                "tokens": toks[:, :LM_CPU_TOKENS].to(d)})
            pre = {k: v.clone() for k, v in cache.items()}
            cache = {k: _fit(cache[k], s.shape) for k, s in spec.items()}
            step, cache = bundle.decode(params, cache, {
                "tokens": toks[:, LM_CPU_TOKENS].to(d),
                "pos": LM_CPU_TOKENS}, **kw)
        out[name] = (logits, pre, step, dict(PM.body_runs))
    (lc, pc, sc, rc), (lh, ph, sh, rh) = out["card"], out["cpu"]
    require(rc == rh and sum(rc.values()) > 0,
            f"{arch} shard bodies on the card {rc}, on the CPU {rh}")
    return dict(cpu_config="smoke", cpu_body_runs=json.dumps(rc),
                cpu_prefill_max_abs=lm_close(lc, lh, "card prefill vs CPU"),
                cpu_cache_max_abs=max(lm_close(pc[k], ph[k],
                                               f"card cache {k} vs CPU")
                                      for k in pc),
                cpu_decode_max_abs=lm_close(sc, sh, "card decode vs CPU"))


def lm_mesh_serve(bundle, params, prompts, mesh, sp: bool, kind: str,
                  warm_gen: int) -> tuple[dict, int, float]:
    """A warm-up call of ``warm_gen`` tokens, then the counted call of
    LM_GEN tokens through ``serve(mesh=, sp=)``: its result, the shard
    bodies of ``kind`` it ran, and its peak MiB above what was held."""
    from repro_torch.launch.serve import serve
    from repro_torch.parallel import mesh as PM
    serve(bundle, params, prompts, warm_gen, mesh=mesh, sp=sp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    PM.reset_body_runs()
    out = serve(bundle, params, prompts, LM_GEN, mesh=mesh, sp=sp)
    runs = PM.body_runs[kind]
    toks = out["tokens"]
    require(toks.shape == (LM_REQUESTS, LM_GEN)
            and ((toks >= 0) & (toks < bundle.cfg.vocab_size)).all()
            and bool(torch.isfinite(out["logits"].float()).all()),
            f"{bundle.cfg.name} served tokens {toks.shape}")
    return out, runs, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def lm_serve_fields(out, params) -> dict:
    from repro_torch.core.pytree import tree_leaves
    leaves = tree_leaves(params)
    steps = LM_GEN - 1
    return dict(params=sum(t.numel() for t in leaves),
                param_gb=round(sum(t.numel() * t.element_size()
                                   for t in leaves) / 1e9, 4),
                dtype="bfloat16", requests=LM_REQUESTS, prompt=LM_PROMPT,
                gen=LM_GEN, prefill_ms=round(out["prefill_s"] * 1e3, 3),
                decode_ms_per_step=round(out["decode_s"] / steps * 1e3, 4),
                tokens_per_s=round(LM_REQUESTS * steps / out["decode_s"], 2),
                sample=json.dumps(out["tokens"][0][:12].tolist()))


def phase_lm_moe(arch: str, shape, dev, card: str, seed: int) -> dict:
    """Phase 13, a MoE line: ``arch`` at full width cut to
    MESH_MOE_LAYERS layers, bf16, seeded, served by ``serve(mesh=)`` on a
    spoofed ``("data", "model")`` mesh of ``shape``: EP where the experts
    divide the model axis, else TP over ``d_ff``.  The prefill's MoE runs
    on every shard (``body_runs``: shards x layers); the decode step keeps
    the one-device ``moe_ffn``, as in the JAX package.  Then the prefill
    and a decode step under the profiler, layer 0's meshed MoE against
    ``moe_ffn`` in float32, the combine's orders, and the card against the
    CPU at smoke size on the same mesh shape."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import DECODE_RULES, activate
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    bundle = build_model(cfg)
    mesh, mesh_fields = lm_mesh(shape, ("data", "model"), dev)
    ep = cfg.n_experts % shape[1] == 0
    with torch.no_grad():
        params = bundle.init(seed=seed, dtype=torch.bfloat16, device=dev)
    prompts = torch.from_numpy(prompts_for(cfg, LM_REQUESTS,
                                           LM_PROMPT)).to(dev)
    out, runs, peak_mib = lm_mesh_serve(bundle, params, prompts, mesh,
                                        False, "moe", 2)
    want_runs = mesh.size * cfg.n_layers
    require(runs == want_runs, f"{arch} MoE shard bodies {runs}, "
                               f"expected {want_runs}")
    fields = lm_serve_fields(out, params)
    with torch.no_grad():
        spec, _ = bundle.cache_spec(LM_REQUESTS, LM_PROMPT + LM_GEN)
        fresh = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for k, s in spec.items()}

        def step():
            with activate(mesh, DECODE_RULES):
                return bundle.decode(params, fresh, {
                    "tokens": prompts[:, 0], "pos": LM_PROMPT})

        def prefill():
            with activate(mesh, DECODE_RULES):
                return bundle.prefill(params, {"tokens": prompts})

        prof = lm_decode_profile(step, fields["decode_ms_per_step"])
        prof.update(lm_decode_profile(prefill, fields["prefill_ms"],
                                      "prefill"))
        check = lm_moe_check(cfg, params, mesh)
        del params, fresh
        torch.cuda.empty_cache()
        n_b = shape[0] if LM_REQUESTS % shape[0] == 0 else 1
        comb = lm_combine_probe(dev, LM_REQUESTS // n_b * LM_PROMPT,
                                cfg.top_k, cfg.d_model, cfg.n_experts)
        cpu = lm_mesh_card_vs_cpu(arch, shape, dev, seed + 1)
    return dict(card=json.dumps(card), arch=arch, **mesh_fields,
                mode="EP" if ep else "TP",
                per_shard=(f"{cfg.n_experts // shape[1]} experts" if ep
                           else f"{cfg.d_ff // shape[1]} of d_ff {cfg.d_ff}"),
                layers=f"{cfg.n_layers}/{full.n_layers}",
                d_model=cfg.d_model, **fields, peak_mib=round(peak_mib, 1),
                body_runs=runs, body_runs_expected=want_runs, **prof,
                **check, **comb, **cpu)


def phase_lm_sp(dev, card: str, seed: int) -> dict:
    """Phase 13, ``lm_sp:``: InternLM2-1.8B at full width and depth, bf16,
    seeded, served by ``serve(mesh=(1, 4), sp=True)`` on a spoofed mesh:
    the horizon LM_PROMPT + LM_GEN splits over the model axis (else the
    baseline would run), and every decode step of every layer runs on the
    4 shards.  Then, fed the same tokens, every decode step's logits
    against the un-meshed decode (LM_ATOL, LM_RTOL) and how many greedy
    tokens agree; the un-meshed serve's decode ms beside; a decode step
    under set_sync_debug_mode("error") and the profiler; the card against
    the CPU at smoke size."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _fit, prompts_for, serve
    from repro_torch.models import build_model
    from repro_torch.parallel.decode import make_sp_attention
    from repro_torch.parallel.sharding import DECODE_RULES_SP, activate
    cfg = get_config(MESH_SP_ARCH)
    bundle = build_model(cfg)
    mesh, mesh_fields = lm_mesh(MESH_SP_SHAPE, ("data", "model"), dev)
    m = mesh.shape["model"]
    horizon = LM_PROMPT + LM_GEN
    require(horizon % m == 0 and (LM_PROMPT + 4) % m == 0,
            f"a horizon of {horizon} slots splits over {m} shards")
    with torch.no_grad():
        params = bundle.init(seed=seed, dtype=torch.bfloat16, device=dev)
    prompts = torch.from_numpy(prompts_for(cfg, LM_REQUESTS,
                                           LM_PROMPT)).to(dev)
    out, runs, peak_mib = lm_mesh_serve(bundle, params, prompts, mesh, True,
                                        "sp_attention", 4)
    want_runs = mesh.size * cfg.n_layers * (LM_GEN - 1)
    require(runs == want_runs, f"SP attention shard bodies {runs}, "
                               f"expected {want_runs}")
    fields = lm_serve_fields(out, params)
    plain = serve(bundle, params, prompts, LM_GEN)
    attn = make_sp_attention(mesh)
    with torch.no_grad():
        with activate(mesh, DECODE_RULES_SP):
            logits, cache = bundle.prefill(params, {"tokens": prompts})
        spec, _ = bundle.cache_spec(LM_REQUESTS, horizon)
        cache = {k: _fit(cache[k], s.shape) for k, s in spec.items()}
        base = {k: v.clone() for k, v in cache.items()}
        tok, errs, agree = logits.argmax(-1), [], 0
        for i in range(LM_GEN - 1):
            pos = LM_PROMPT + i
            with activate(mesh, DECODE_RULES_SP):
                got, cache = bundle.decode(params, cache, {
                    "tokens": tok, "pos": pos}, attn_impl=attn)
            want, base = bundle.decode(params, base, {"tokens": tok,
                                                      "pos": pos})
            errs.append(lm_close(got, want, f"SP decode step {i} vs "
                                            f"un-meshed"))
            agree += int((got.argmax(-1) == want.argmax(-1)).sum())
            tok = got.argmax(-1)
        fresh = {k: torch.zeros_like(v) for k, v in cache.items()}

        def step():
            with activate(mesh, DECODE_RULES_SP):
                return bundle.decode(params, fresh, {
                    "tokens": prompts[:, 0], "pos": LM_PROMPT},
                    attn_impl=attn)

        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prof = lm_decode_profile(step, fields["decode_ms_per_step"])
        del params, cache, base, fresh
        torch.cuda.empty_cache()
        cpu = lm_mesh_card_vs_cpu(MESH_SP_ARCH, MESH_SP_SHAPE, dev, seed + 1,
                                  sp=True)
    return dict(card=json.dumps(card), arch=MESH_SP_ARCH, **mesh_fields,
                layers=f"{cfg.n_layers}/{cfg.n_layers}", horizon=horizon,
                slots_per_shard=horizon // m, **fields,
                peak_mib=round(peak_mib, 1),
                unmeshed_decode_ms_per_step=round(
                    plain["decode_s"] / (LM_GEN - 1) * 1e3, 4),
                body_runs=runs, body_runs_expected=want_runs,
                decode_vs_unmeshed_max_abs=max(errs),
                tokens_agree=f"{agree}/{LM_REQUESTS * (LM_GEN - 1)}",
                sync_free=True, **prof, **cpu)


def pipeline_run(cfg, layers, xs, mesh):
    """``pipeline_forward`` and ``sequential_reference`` of the port's
    ``transformer_layer`` (one a stage) over the microbatches ``xs``; the
    positions are made on the device of the stage that runs."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.pipeline import (pipeline_forward,
                                               sequential_reference)

    def layer_fn(p, x):
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        return T.transformer_layer(x, p, cfg, positions)[0]

    return (lambda: pipeline_forward(layer_fn, layers, xs, mesh),
            lambda: sequential_reference(layer_fn, layers, xs))


def phase_pipeline(dev, card: str, seed: int) -> dict:
    """Phase 13, ``pipeline:``: PIPE_STAGES DeepSeek-67B decoder layers at
    full width (bf16, seeded), one a stage of a spoofed ``("stage",)``
    mesh, PIPE_MICRO microbatches of PIPE_MB x PIPE_SEQ tokens through
    ``pipeline_forward`` (``body_runs``: stages x (M + S - 1) ticks),
    equal to ``sequential_reference`` bit for bit; both timed, the
    pipeline under the profiler, and the card against the CPU at smoke
    width (the same schedule)."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.models import build_model
    from repro_torch.models.layers import bf16_layers
    from repro_torch.parallel import mesh as PM
    full = get_config(PIPE_ARCH)
    cfg = dataclasses.replace(full, n_layers=PIPE_STAGES)
    mesh, mesh_fields = lm_mesh((PIPE_STAGES,), ("stage",), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        layers = bf16_layers(build_model(cfg).init(
            seed=seed, dtype=torch.bfloat16, device=dev)["layers"])
        torch.cuda.empty_cache()
        xs = torch.randn(PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model,
                         generator=gen, device=dev, dtype=torch.bfloat16)
        pipe, seq = pipeline_run(cfg, layers, xs, mesh)
        pipe()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        PM.reset_body_runs()
        t0 = time.perf_counter()
        got = pipe()
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        runs = PM.body_runs["pipeline"]
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        t0 = time.perf_counter()
        want = seq()
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        diff = (got.float() - want.float()).abs().max().item()
        want_runs = PIPE_STAGES * (PIPE_MICRO + PIPE_STAGES - 1)
        require(runs == want_runs, f"pipeline stage bodies {runs}, "
                                   f"expected {want_runs}")
        require(bool(torch.isfinite(got.float()).all()), "pipeline finite")
        require(torch.equal(got, want), f"pipeline against sequential: "
                                        f"max abs {diff}")
        prof = lm_decode_profile(pipe, pipe_s * 1e3, "pipeline")
        layer_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves(layers)) / PIPE_STAGES / 1e9
        del layers, xs, got, want
        torch.cuda.empty_cache()
        # the card against the CPU: the smoke width, the same schedule
        small = dataclasses.replace(get_smoke_config(PIPE_ARCH),
                                    n_layers=PIPE_STAGES)
        on_cpu = bf16_layers(build_model(small).init(
            seed=seed + 1, dtype=torch.bfloat16, device="cpu")["layers"])
        x_cpu = torch.randn(PIPE_MICRO, PIPE_MB, LM_CPU_TOKENS,
                            small.d_model, generator=torch.Generator(
                                device="cpu").manual_seed(seed + 1),
                            dtype=torch.bfloat16)
        res = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            m, _ = lm_mesh((PIPE_STAGES,), ("stage",), d)
            res[name] = pipeline_run(small, tree_map(lambda t: t.to(d),
                                                     on_cpu),
                                     x_cpu.to(d), m)[0]()
        cpu_err = lm_close(res["card"], res["cpu"], "card pipeline vs CPU")
    return dict(card=json.dumps(card), arch=PIPE_ARCH, **mesh_fields,
                layers=f"{PIPE_STAGES}/{full.n_layers}",
                d_model=cfg.d_model, d_ff=cfg.d_ff,
                layer_gb=round(layer_gb, 4), microbatches=PIPE_MICRO,
                microbatch=f"{PIPE_MB}x{PIPE_SEQ}",
                pipeline_ms=round(pipe_s * 1e3, 3),
                sequential_ms=round(seq_s * 1e3, 3),
                tokens_per_s=round(PIPE_MICRO * PIPE_MB * PIPE_SEQ / pipe_s,
                                   2),
                peak_mib=round(peak_mib, 1), body_runs=runs,
                body_runs_expected=want_runs, equal_to_sequential=True,
                sequential_max_abs=diff, **prof, cpu_max_abs=cpu_err)


def phase_lm_mesh(dev, card: str) -> tuple[list, dict]:
    """Phase 13: the LM stack's parallel pieces on spoofed meshes of the
    one card (the MoE in EP and TP mode, sequence-parallel decode, the
    pipeline), which run no hand-written kernel: the launch counts are set
    to 0 before the phase and read after it."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [(name, phase_lm_moe(arch, shape, dev, card, SEED + 70 + 2 * i))
             for i, (name, arch, shape) in enumerate(MESH_MOE)]
    lines.append(("lm_sp", phase_lm_sp(dev, card, SEED + 74)))
    lines.append(("pipeline", phase_pipeline(dev, card, SEED + 76)))
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(sum(counts.values()) == 0, f"the LM mesh launched {counts}")
    for _, fields in lines:
        fields["kernel_launches"] = 0
    return lines, counts


# --------------------------------------------------- 14. LM training

LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_STEPS = 4096, 4, 4   # train_4k's seq
LM_REMAT_LAYERS, LM_REMAT_SEQ = 2, 1024   # what fits without remat
# examples/train_lm.py --size 100m: 12 x 768, GQA 12/4, vocab 32000
LM100M = dict(name="lm100m", family="dense", n_layers=12, d_model=768,
              n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32000,
              head_dim=64)
LM100M_BATCH, LM100M_SEQ, LM100M_STEPS, LM100M_STOP = 8, 256, 200, 100
# the fall of the loss, the mean of the first ten less the mean of the
# last ten: the tiny config of examples/train_lm.py (2 x 128, vocab 2048)
# through launch.train on the CPU, same batch, seq, lr 3e-4, warm-up 50
# and 200 steps, falls 8.0094 -> 5.0791 (2.9303); lm100m must fall by at
# least half of that
LM100M_MIN_FALL = 1.46
LM_ELASTIC_STEPS, LM_ELASTIC_MESHES = 20, ((4, 2), (2, 2))
# card against CPU, a Mixtral smoke step on (1, 2) in bf16: the global
# gradient's relative error, 0.003004 on the H100 (routing may flip on a
# near-tie of bf16 router logits, as found for serving), held at 0.01
LM_GRAD_RTOL = 0.01


def lm_train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N per token (forward and
    backward of every weight), plus causal attention's two products over
    half the S x S scores, three times (forward, two in the backward);
    rematerialisation's recompute is not counted."""
    hd = cfg.resolved_head_dim()
    attn = 6 * cfg.n_layers * batch * cfg.n_heads * seq * seq * hd
    return 6 * n_params * batch * seq + attn


def lm_loss_no_remat(cfg):
    """``transformer_loss`` with every layer's activations kept
    (``remat=False``): the same function of the parameters."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import cross_entropy

    def loss(params, batch):
        toks = batch["tokens"]
        logits, aux = T.transformer_logits(params, cfg, toks[:, :-1],
                                           batch.get("image_embeds"),
                                           remat=False)
        return cross_entropy(logits, toks[:, 1:]) + 0.01 * aux

    return loss


def lm_remat_check(cfg, dev) -> dict:
    """InternLM2-1.8B at full width cut to LM_REMAT_LAYERS layers, seeded,
    LM_TRAIN_BATCH x LM_REMAT_SEQ tokens: the loss and every gradient with
    remat (``bundle.loss``) and without, ``torch.equal``; each one's peak
    memory above the resident parameters."""
    import dataclasses
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.engine.train_loop import _value_and_grad
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models import build_model
    cut = dataclasses.replace(cfg, n_layers=LM_REMAT_LAYERS)
    bundle = build_model(cut)
    params = bundle.init(seed=SEED + 80, device=dev)
    batch = batch_fn_for(cut, LM_REMAT_SEQ, LM_TRAIN_BATCH, dev)(0)
    out = {}
    for name, fn in (("remat", bundle.loss),
                     ("no_remat", lm_loss_no_remat(cut))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = _value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
        out[name] = (loss, tree_leaves(grads),
                     (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    (l1, g1, m1), (l0, g0, m0) = out["remat"], out["no_remat"]
    require(bool(torch.isfinite(l1)) and torch.equal(l1, l0),
            f"remat loss {l1.item()} against {l0.item()}")
    require(all(torch.equal(a, b) for a, b in zip(g1, g0)),
            "remat gradients equal the kept-activation gradients")
    return dict(remat_layers=LM_REMAT_LAYERS, remat_seq=LM_REMAT_SEQ,
                remat_loss=round(l1.item(), 6), remat_equal=True,
                remat_peak_mib=round(m1, 1), no_remat_peak_mib=round(m0, 1))


def lm_train_full(dev, card: str) -> dict:
    """``lm_train:`` InternLM2-1.8B at full width and depth (float32
    parameters, seeded; bf16 activations, every layer and q chunk
    rematerialised) through ``launch.train.train``: LM_TRAIN_STEPS AdamW
    steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens (train_4k's sequence;
    its batch of 256 cut to what one card holds), no checkpoint.  Step ms
    (median after one warm step), tokens/s, peak MiB, the model FLOPs'
    share of the bf16 peak; one more step profiled; then the remat check
    (:func:`lm_remat_check`)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.engine.train_loop import make_train_step
    from repro_torch.launch.train import batch_fn_for, train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, hist = train(LM_ARCH, steps=LM_TRAIN_STEPS, seq=LM_TRAIN_SEQ,
                        batch=LM_TRAIN_BATCH, device=dev, log_fn=_quiet)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    losses = hist["loss"]
    require(len(losses) == LM_TRAIN_STEPS
            and all(math.isfinite(x) for x in losses)
            and all(math.isfinite(x) for x in hist["grad_norm"]),
            f"full-width losses {losses}")
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    step_s = float(np.median(hist["step_time"][1:]))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = lm_train_flops(cfg, n_params, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    step_fn = make_train_step(build_model(cfg).loss, AdamWConfig())
    batch = batch_fn_for(cfg, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                         dev)(LM_TRAIN_STEPS)
    prof = lm_decode_profile(lambda: step_fn(state, batch), step_s * 1e3,
                             prefix="train", warm=False)   # trained: warm
    del state, batch
    torch.cuda.empty_cache()
    return dict(card=json.dumps(card), arch=LM_ARCH, params=n_params,
                dtype="float32 params, bf16 activations", remat=True,
                batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                cut="batch 256 -> 4", steps=LM_TRAIN_STEPS,
                losses=json.dumps([round(x, 5) for x in losses]),
                step_ms=round(step_s * 1e3, 3),
                step_times_ms=json.dumps([round(t * 1e3, 3)
                                          for t in hist["step_time"]]),
                train_s=round(train_s, 2),
                tokens_per_s=round(tokens / step_s, 2),
                peak_mib=round(peak_mib, 1), model_flops=flops,
                model_tflop_per_s=round(flops / step_s / 1e12, 3),
                bf16_peak_share=round(flops / step_s / BF16_FLOP_PER_S, 5),
                **prof, **lm_remat_check(cfg, dev))


def lm_train_100m(dev, card: str) -> dict:
    """``lm_train_100m:`` the twin of ``examples/train_lm.py --size 100m``
    (LM100M, float32 parameters, AdamW lr 3e-4 with 50 warm-up steps) on
    LM100M_BATCH x LM100M_SEQ tokens: LM100M_STEPS steps uninterrupted,
    checkpointed every LM100M_STOP; then a second run resumed from the
    checkpoint written at LM100M_STOP (copied to a directory of its own)
    to LM100M_STEPS, ``torch.equal`` to the first (parameters, optimiser
    state and every loss after LM100M_STOP); the loss falls by
    LM100M_MIN_FALL."""
    import shutil
    from repro_torch.configs.common import ArchConfig
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.train import train
    cfg = ArchConfig(**LM100M)
    root = ROOT / "build" / "lm_train_100m"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(seq=LM100M_SEQ, batch=LM100M_BATCH, lr=3e-4, warmup_steps=50,
              checkpoint_every=LM100M_STOP, device=dev, log_fn=_quiet)
    try:
        whole, hist = train(cfg, steps=LM100M_STEPS, ckpt=str(root / "a"),
                            **kw)
        stop = f"step_{LM100M_STOP:08d}"
        shutil.copytree(root / "a" / stop, root / "b" / stop)
        resumed, rest = train(cfg, steps=LM100M_STEPS, ckpt=str(root / "b"),
                              **kw)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(rest["start"] == LM100M_STOP, f"resumed at {rest['start']}")
    require(rest["loss"] == hist["loss"][LM100M_STOP:],
            "the resumed losses equal the uninterrupted run's")
    require(all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                  tree_leaves(resumed))),
            "the resumed state equals the uninterrupted run's")
    losses = hist["loss"]
    fall = float(np.mean(losses[:10]) - np.mean(losses[-10:]))
    require(all(math.isfinite(x) for x in losses)
            and fall >= LM100M_MIN_FALL,
            f"lm100m loss fell by {fall} (at least {LM100M_MIN_FALL})")
    n_params = sum(t.numel() for t in tree_leaves(whole["params"]))
    step_s = float(np.median(hist["step_time"][1:]))
    return dict(card=json.dumps(card), config=json.dumps(LM100M),
                params=n_params, batch=LM100M_BATCH, seq=LM100M_SEQ,
                steps=LM100M_STEPS, stopped_at=LM100M_STOP,
                resume_equal=True, loss_first=round(losses[0], 5),
                loss_last=round(losses[-1], 5), loss_fall=round(fall, 5),
                min_fall=LM100M_MIN_FALL, step_ms=round(step_s * 1e3, 3),
                tokens_per_s=round(LM100M_BATCH * LM100M_SEQ / step_s, 2),
                stragglers=hist["stragglers"],
                resumed_stragglers=rest["stragglers"],
                checkpoints=json.dumps(hist["checkpoints"]))


def lm_elastic(dev) -> dict:
    """The twin of tests/test_elastic.py on spoofed meshes of the card:
    the smoke InternLM2 (seq 32, batch 8, AdamW lr 1e-3, one warm-up step)
    LM_ELASTIC_STEPS // 2 steps on the first mesh with a checkpoint,
    resumed on the second to LM_ELASTIC_STEPS, against an uninterrupted
    run on the first: ``torch.equal``."""
    import shutil
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.train import train
    root = ROOT / "build" / "lm_train_elastic"
    shutil.rmtree(root, ignore_errors=True)
    (d1, m1), (d2, m2) = LM_ELASTIC_MESHES
    half = LM_ELASTIC_STEPS // 2
    kw = dict(smoke=True, seq=32, batch=8, lr=1e-3, warmup_steps=1,
              checkpoint_every=half, device=dev, log_fn=_quiet)
    try:
        whole, hist = train(LM_ARCH, steps=LM_ELASTIC_STEPS,
                            mesh=(d1, m1), spoof_devices=d1 * m1, **kw)
        _, a = train(LM_ARCH, steps=half, mesh=(d1, m1),
                     spoof_devices=d1 * m1, ckpt=str(root), **kw)
        resumed, b = train(LM_ARCH, steps=LM_ELASTIC_STEPS, mesh=(d2, m2),
                           spoof_devices=d2 * m2, ckpt=str(root), **kw)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(b["start"] == half, f"elastic resume at {b['start']}")
    require(a["loss"] + b["loss"] == hist["loss"]
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(whole),
                                                      tree_leaves(resumed))),
            "the elastic restart equals the uninterrupted run")
    return dict(elastic=json.dumps([list(m) for m in LM_ELASTIC_MESHES]),
                elastic_steps=LM_ELASTIC_STEPS, elastic_resumed_at=half,
                elastic_equal=True, elastic_loss=round(hist["loss"][-1], 6))


def lm_spmd_step(dev) -> dict:
    """The twin of test_sharding.py::test_train_step_spmd_8dev on the card:
    one smoke InternLM2 train step (AdamW lr 1e-3, one warm-up step, a
    batch of ones [8, 17]) on a spoofed (4, 2) mesh under the training
    rules, equal bit for bit to the step on the card alone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.engine.train_loop import (init_train_state,
                                               make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import TRAIN_RULES, activate
    bundle = build_model(get_smoke_config(LM_ARCH))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    step = make_train_step(bundle.loss, opt)
    batch = {"tokens": torch.ones((8, 17), dtype=torch.int32, device=dev)}
    out = []
    for shape in ((4, 2), None):
        state = init_train_state(None, bundle.init(seed=SEED + 84,
                                                   device=dev), opt).as_tree()
        if shape is None:
            out.append(step(state, batch))
            continue
        mesh, _ = lm_mesh(shape, ("data", "model"), dev)
        with activate(mesh, TRAIN_RULES):
            out.append(step(state, batch))
    (new, metrics), (want, wmetrics) = out
    require(bool(torch.isfinite(metrics["loss"]))
            and all(torch.equal(metrics[k], wmetrics[k]) for k in wmetrics)
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                      tree_leaves(want))),
            "the (4, 2) mesh step equals the one-device step")
    return dict(spmd_mesh="[4, 2]", spmd_equal=True,
                spmd_loss=round(metrics["loss"].item(), 6))


def lm_moe_step_card_vs_cpu(dev) -> dict:
    """One Mixtral smoke train step's loss and gradient on a spoofed
    (1, 2) mesh under the training rules (the meshed MoE), seeded on the
    CPU and copied: the card against the CPU, the loss at the bf16
    tolerance, the whole gradient within LM_GRAD_RTOL of its norm; the
    same shard bodies on both."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.engine.train_loop import _value_and_grad
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as PM
    from repro_torch.parallel.sharding import TRAIN_RULES, activate
    cfg = get_smoke_config("mixtral_8x7b")
    bundle = build_model(cfg)
    on_cpu = bundle.init(seed=SEED + 82, device="cpu")
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        mesh, _ = lm_mesh((1, 2), ("data", "model"), d)
        PM.reset_body_runs()
        with activate(mesh, TRAIN_RULES):
            loss, grads = _value_and_grad(
                bundle.loss, tree_map(lambda t: t.to(d), on_cpu),
                batch_fn_for(cfg, 64, 8, d)(0))
        flat = torch.cat([g.reshape(-1).float().cpu()
                          for g in tree_leaves(grads)])
        out[name] = (loss.cpu(), flat, dict(PM.body_runs))
    (lc, gc, rc), (lh, gh, rh) = out["card"], out["cpu"]
    require(rc == rh and rc.get("moe", 0) > 0,
            f"MoE shard bodies on the card {rc}, on the CPU {rh}")
    rel = ((gc - gh).norm() / gh.norm()).item()
    require(bool(torch.isfinite(gc).all()) and rel <= LM_GRAD_RTOL,
            f"Mixtral step gradient, card against CPU: relative {rel}")
    return dict(moe_step_body_runs=json.dumps(rc),
                moe_step_loss_max_abs=lm_close(lc, lh,
                                               "Mixtral step loss vs CPU"),
                moe_step_grad_rel=round(rel, 6),
                moe_step_grad_rtol=LM_GRAD_RTOL)


def phase_lm_train(dev, card: str) -> tuple[list, dict]:
    """Phase 14: LM training through ``launch.train.train``, which runs no
    hand-written kernel: the launch counts are set to 0 before the phase
    and read after it."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [("lm_train", lm_train_full(dev, card)),
             ("lm_train_100m", lm_train_100m(dev, card)),
             ("lm_train_mesh", dict(card=json.dumps(card), **lm_elastic(dev),
                                    **lm_spmd_step(dev),
                                    **lm_moe_step_card_vs_cpu(dev)))]
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(sum(counts.values()) == 0, f"LM training launched {counts}")
    for _, fields in lines:
        fields["kernel_launches"] = 0
    return lines, counts


DRYRUN_LAYERS = 2            # phase 15 (a): InternLM2-1.8B cut to 2 layers
DRYRUN_BATCH, DRYRUN_SEQ = 2, 1024


def dryrun_meta_vs_card(dev) -> dict:
    """Phase 15 (a): InternLM2-1.8B at full width cut to DRYRUN_LAYERS
    layers; a training step (float32 parameters, AdamW), a prefill of
    DRYRUN_BATCH x DRYRUN_SEQ tokens and one decode step against a cache
    of DRYRUN_SEQ slots (bf16), each counted by the dry-run
    (``launch.dryrun.lower_cell`` at full depth on a 1 x 1 mesh) on meta
    tensors and again on the card (seeded weights) under the same
    counter.  Every count equal: FLOPs, dot FLOPs, bytes, argument and
    peak live bytes, outputs, donated bytes, collectives."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=DRYRUN_LAYERS)
    out = dict(layers=DRYRUN_LAYERS, batch=DRYRUN_BATCH, seq=DRYRUN_SEQ)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(f"{kind}_{DRYRUN_SEQ}", DRYRUN_SEQ, DRYRUN_BATCH,
                          kind)
        got = {}
        for d in ("meta", dev):
            mesh = make_mesh((1, 1), ("data", "model"), device=d)
            traced, meta = D.lower_cell(LM_ARCH, shape, mesh, device=d,
                                        full_depth=True, cfg=cfg)
            got[torch.device(d).type] = traced.tally, meta["compile_s"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        (m, m_s), (c, c_s) = got["meta"], got[torch.device(dev).type]
        diff = {k: (m[k], c[k]) for k in m if m[k] != c[k]}
        require(not diff, f"dry-run {kind}: meta and card differ: {diff}")
        out.update({f"{kind}_flops": m["flops"],
                    f"{kind}_dot_flops": m["dot_flops"],
                    f"{kind}_bytes": m["bytes"],
                    f"{kind}_argument_bytes": m["argument_bytes"],
                    f"{kind}_temp_bytes": m["temp_bytes"],
                    f"{kind}_meta_s": round(m_s, 3),
                    f"{kind}_card_s": round(c_s, 3)})
    out["meta_equals_card"] = True
    return out


def dryrun_lm_train(card: str, measured: dict) -> dict:
    """Phase 15 (b): the ``lm_train:`` cell (InternLM2-1.8B, full width
    and depth, LM_TRAIN_BATCH x LM_TRAIN_SEQ) counted on meta tensors at
    full depth, beside what phase 14 measured on the card in this
    process (``measured``, its line): the counted FLOPs, the model FLOPs
    (6 N D) and their share of the count, the roofline terms on the
    H100's data-sheet rates against the measured step, and the counted
    peak (arguments plus live temporaries) against
    ``max_memory_allocated``."""
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    shape = ShapeSpec("train_4k", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    traced, meta = D.lower_cell(LM_ARCH, shape, mesh, device="meta",
                                full_depth=True)
    rec = D.analyze(traced, meta, 1)
    r, mem, t = rec["roofline"], rec["memory"], traced.tally
    require(t["dot_flops"] >= rec["model_flops"] > 0
            and all(math.isfinite(r[k]) and r[k] > 0
                    for k in ("compute_s", "memory_s")),
            f"dry-run lm_train cell: {rec['loop_aware']}, {r}")
    counted_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    step_ms = measured["step_ms"]
    return dict(card=json.dumps(card), arch=LM_ARCH, batch=LM_TRAIN_BATCH,
                seq=LM_TRAIN_SEQ, trace_s=round(meta["compile_s"], 2),
                flops=t["flops"], dot_flops=t["dot_flops"], bytes=t["bytes"],
                raw_flops=t["raw_flops"], model_flops=rec["model_flops"],
                useful_ratio=round(rec["useful_ratio"], 5),
                hand_model_flops=measured["model_flops"],
                compute_ms=round(r["compute_s"] * 1e3, 3),
                memory_ms=round(r["memory_s"] * 1e3, 3),
                dominant=r["dominant"],
                bound_ms=round(r["step_time_s"] * 1e3, 3),
                measured_step_ms=step_ms,
                measured_over_bound=round(step_ms / (r["step_time_s"] * 1e3),
                                          3),
                counted_tflop_per_s=round(t["flops"] / step_ms / 1e9, 3),
                argument_mib=round(mem["argument_size_in_bytes"] / 2 ** 20,
                                   1),
                temp_mib=round(mem["temp_size_in_bytes"] / 2 ** 20, 1),
                counted_peak_mib=round(counted_peak / 2 ** 20, 1),
                measured_peak_mib=measured["peak_mib"],
                measured_over_counted_peak=round(
                    measured["peak_mib"] * 2 ** 20 / counted_peak, 4))


def phase_dryrun(dev, card: str, measured: dict) -> tuple[list, dict]:
    """Phase 15: the dry-run tools, which launch no hand-written kernel
    (the counts are set to 0 before the phase and read after it)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    lines = [("dryrun", dict(card=json.dumps(card),
                             **dryrun_meta_vs_card(dev))),
             ("dryrun_lm_train", dryrun_lm_train(card, measured))]
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    require(sum(counts.values()) == 0, f"the dry-run launched {counts}")
    for _, fields in lines:
        fields["kernel_launches"] = 0
    return lines, counts


def device_ms_by_name(prof) -> dict:
    """Device time in ms of a profiler trace, summed by kernel name (the
    template arguments dropped) and by copy kind."""
    from torch.autograd import DeviceType
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name if "Memcpy" in e.name else e.name.split("<")[0]
            device[key] = device.get(key, 0.0) + e.device_time_total / 1e3
    return device


def phase_breakdown(packed, streams, plan) -> dict:
    """Where one engine call of ``plan`` goes: each stage of run_batched
    timed on the host clock around synchronised work, and the device's busy
    time (kernels and copies) from the profiler over the same window."""
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
    device = device_ms_by_name(prof)
    wall = sum(stages.values())
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    return dict(bucket=f"{plan.b_pad}x{plan.t_pad}",
                stage_ms=json.dumps({k: round(v, 3)
                                     for k, v in stages.items()}),
                wall_ms=round(wall, 3), device_busy_ms=round(busy, 3),
                device_idle_share=round(1 - busy / wall, 4),
                device_ms=json.dumps({k: round(v, 3) for k, v in top}))


def same_stats(a: list, b: list) -> bool:
    """Two per-layer lists of DispatchStats, counter for counter."""
    fields = ("cycles", "rows_touched", "engine_ops", "events",
              "sn_bytes_touched")
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        and x.mem_e_peak == y.mem_e_peak for x, y in zip(a, b)
        for f in fields)


def same_result(a, b) -> bool:
    return (np.array_equal(a.out_spikes, b.out_spikes)
            and same_stats(a.stats, b.stats))


def oracle_equal(r, oracle) -> bool:
    """A served request equal to the numpy oracle's run on it: spikes,
    every dispatch counter, and the energy report."""
    return (np.array_equal(r.out_spikes, oracle.out_spikes)
            and same_stats(r.stats, oracle.per_layer_stats)
            and r.energy() == oracle.energy)


def drive(packed, streams, policy, telemetry=None, mesh=None):
    """One counted run of the main path (sharded over ``mesh`` when given):
    the counts go to 0 just before it and are read just after."""
    from repro_torch.engine import run_bucketed
    from repro_torch.kernels import _build
    sync_all()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_bucketed(packed, streams, policy=policy, telemetry=telemetry,
                       mesh=mesh)
    sync_all()
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
    from repro_torch.configs.menage_paper import (ACCEL_1, ACCEL_2,
                                                  CIFAR_DATA, CIFAR_SNN,
                                                  NMNIST_DATA, NMNIST_SNN)
    from repro_torch.core.accelerator import map_model, run
    from repro_torch.engine import BatchPlan
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase_s: dict[str, float] = {}
    mark = [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        took, mark[0] = round(now - mark[0], 2), now
        return took

    # 1. build
    build_s = _build.build_all()
    regs = {name: ptxas_registers(text)
            for name, text in _build.build_log.items()}
    log("build", seconds=round(build_s, 2), torch=torch.__version__,
        cuda=torch.version.cuda, ptxas=json.dumps(regs))
    phase_s["build"] = lap()

    # the CIFAR10-DVS MLP at native width, on Accel_2
    m = cifar_model(dev)
    streams, policy, plans, big = (m["streams"], m["policy"], m["plans"],
                                   m["big"])
    x_big, ws, gain, mapped = m["x_big"], m["ws"], m["gain"], m["mapped"]
    dense, packed = m["dense"], m["packed"]
    map_s, pack_s, pack_mib = m["map_s"], m["pack_s"], m["pack_mib"]
    log("map", model="cifar10_dvs", sizes=list(CIFAR_SNN.layer_sizes),
        accel=ACCEL_2.name, gain=gain, map_s=round(map_s, 2),
        pack_s=round(pack_s, 2), pack_mib=round(pack_mib, 1),
        rounds=[len(l.rounds) for l in mapped.layers],
        sram_bytes=[l.sram_bytes for l in mapped.layers])
    phase_s["map"] = lap()

    # 2. kernels against their plain versions, at the main path's shapes
    kernels = phase_kernels(dense, packed, x_big)
    kernels.append(phase_c2c(ws[0], x_big))
    from repro_torch.engine.batched_run import _forward_impl
    b_big, t_big, _ = x_big.shape
    l1 = _forward_impl(dense, x_big, None)[0]
    log("event_lists", **phase_event_lists(
        dense, packed, l1.reshape(b_big * t_big, -1).contiguous()))
    log("sync_free", **phase_sync_free({"dense": dense, "packed": packed},
                                       x_big))
    phase_s["kernels"] = lap()

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
    phase_s["serve"] = lap()

    # 4. stream: the always-on server in front of the same packed model
    rng_s = np.random.default_rng(SEED + 5)
    log("stream", **phase_stream(
        dense, lambda lengths: rate_map_streams(rng_s, CIFAR_DATA, lengths),
        policy, telemetry))
    phase_s["stream"] = lap()

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
    packed4 = mapped4.pack(device=dev)
    res4, counts4, _ = drive(packed4, streams4, policy)
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
    phase_s["nmnist4"] = lap()

    # 6. socket: the wire front end serving both tenants on the card
    sock = phase_socket(dense, packed, mapped4, packed4, policy,
                        (CIFAR_DATA, NMNIST_DATA))
    log("socket", **sock)
    counts_sock = json.loads(sock["launches"])
    phase_s["socket"] = lap()

    # 7. precision: searched per-layer widths served on the packed kernels
    prec = phase_precision(policy, dev, card)
    log("precision", **prec)
    counts_prec = json.loads(prec["launches"])
    phase_s["precision"] = lap()

    # 8. spikify: a transformer FFN's widths on the dense event kernel
    spk, spk_row = phase_spikify(dev, card)
    log("spikify", **spk)
    counts_spk = json.loads(spk["launches"])
    phase_s["spikify"] = lap()

    # 9. train: both families trained on the card, then served
    train_lines, counts_train = phase_train(dev, card)
    for name, fields in train_lines:
        log(name, **fields)
    phase_s["train"] = lap()

    for row in kernels:
        row["launches"] = (counts_pk if row["name"] == "event_synapse_packed"
                           else counts)[row["name"]]
        row["socket_launches"] = counts_sock[row["name"]]
        row["precision_launches"] = counts_prec[row["name"]]
        row["spikify_launches"] = counts_spk[row["name"]]
    kernels.append(spk_row)
    for row in kernels:
        row["train_launches"] = counts_train[row["name"]]

    # 10. mesh: the data-parallel mesh, serving, device loss and training
    mesh_lines, counts_mesh = phase_mesh(
        dev, card, mapped, {"dense": dense, "packed": packed}, streams)
    for name, fields in mesh_lines:
        log(name, **fields)
    for row in kernels:
        row["mesh_launches"] = (
            counts_mesh["packed"] if row["name"] == "event_synapse_packed"
            else counts_mesh["dense"])[row["name"]]
    phase_s["mesh"] = lap()

    # 11. lm: the LM serving path at full width, no hand-written kernel
    lm_lines, counts_lm = phase_lm(dev, card)
    for name, fields in lm_lines:
        log(name, **fields)
    for row in kernels:
        row["lm_launches"] = counts_lm[row["name"]]
    phase_s["lm"] = lap()

    # 12. lm_models: the SSM, hybrid and encoder-decoder LMs at full width
    lm_lines, counts_lm = phase_lm_models(dev, card)
    for name, fields in lm_lines:
        log(name, **fields)
    for row in kernels:
        row["lm_models_launches"] = counts_lm[row["name"]]
    phase_s["lm_models"] = lap()

    # 13. lm_mesh: the MoE (EP, TP), SP decode and the pipeline on meshes
    lm_lines, counts_lm = phase_lm_mesh(dev, card)
    for name, fields in lm_lines:
        log(name, **fields)
    for row in kernels:
        row["lm_mesh_launches"] = counts_lm[row["name"]]
    phase_s["lm_mesh"] = lap()

    # 14. lm_train: InternLM2-1.8B trained at full width, lm100m resumed,
    # the elastic restart and the meshed MoE step
    lm_lines, counts_lm = phase_lm_train(dev, card)
    for name, fields in lm_lines:
        log(name, **fields)
    for row in kernels:
        row["lm_train_launches"] = counts_lm[row["name"]]
    phase_s["lm_train"] = lap()

    # 15. dryrun: the counted step, on meta against the card, and the
    # full-depth lm_train: cell beside its measured step
    dr_lines, counts_dr = phase_dryrun(dev, card, dict(lm_lines)["lm_train"])
    for name, fields in dr_lines:
        log(name, **fields)
    for row in kernels:
        row["dryrun_launches"] = counts_dr[row["name"]]
    phase_s["dryrun"] = lap()
    log("timing", **phase_s)
    keys = ("name", "path", "route", "source", "replaces", "launches",
            "socket_launches", "precision_launches", "spikify_launches",
            "train_launches", "mesh_launches", "lm_launches",
            "lm_models_launches", "lm_mesh_launches", "lm_train_launches",
            "dryrun_launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "on_path")
    print(card)
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
