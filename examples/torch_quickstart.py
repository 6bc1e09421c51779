"""Quickstart in PyTorch (the twin of examples/quickstart.py): the full
MENAGE flow (paper Algorithm 1) through the port.

Trains a small spiking MLP on a synthetic event dataset, prunes and
quantizes it, solves the ILP mapping, builds the control memories, runs an
input on the cycle-level accelerator twin (bit-exact against the dense
reference), prints the Table-II-style energy report, then runs a batch
through the batched engine's hand-written kernels on the card (equal to
the twin, sample for sample) and serves variable-length requests through
the bucketed front end.

  PYTHONPATH=src python examples/torch_quickstart.py
  # on the CPU (the kernels' plain versions):
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 20
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.accelerator import (map_model, reference_forward, run,
                                          run_batch)
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.prune import prune_pytree, sparsity
from repro_torch.core.quant import quantize_pytree
from repro_torch.data.events import (EventDatasetConfig, event_batches,
                                     synthetic_event_dataset)
from repro_torch.device import resolve_device
from repro_torch.engine import (MLP_MODEL, BucketPolicy, SNNTrainConfig,
                                run_batched, run_bucketed, trace_count,
                                train_snn_model)
from repro_torch.snn.mlp import SNNConfig, snn_forward_batch_major


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card "
                         "(raises with no card); cpu: their plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # 1. data + model (a small N-MNIST-like setup)
    data_cfg = EventDatasetConfig("quickstart", 16, 16, num_steps=20,
                                  base_rate=0.01, signal_rate=0.4)
    snn_cfg = SNNConfig(layer_sizes=(data_cfg.n_in, 64, 32, 10), num_steps=20)
    spikes, labels = synthetic_event_dataset(data_cfg, n_per_class=16,
                                             rng=np.random.default_rng(0))

    # 2. train (surrogate gradients, the engine's loop), prune, quantize
    #    (Algorithm 1 steps 1-3)
    it = event_batches(spikes, labels, batch=32)
    params, hist = train_snn_model(
        MLP_MODEL, snn_cfg, it, SNNTrainConfig(steps=args.steps,
                                               log_every=100),
        key=torch.Generator().manual_seed(1), device=dev)
    print(f"trained on {dev.type}: final loss={hist['loss'][-1]:.3f} "
          f"acc={hist['acc'][-1]:.2f}")
    pruned, _ = prune_pytree(params, 0.5)
    _, weights = quantize_pytree(pruned)
    print(f"pruned to {sparsity(pruned):.0%} sparsity, 8-bit quantized")

    # 3. ILP mapping onto an accelerator design point (steps 4-5)
    accel = AcceleratorSpec("quickstart", n_cores=3, n_engines=8, n_caps=8,
                            weight_mem_bytes=1 << 20)
    model = map_model([w.cpu().numpy() for w in weights], accel,
                      lif=snn_cfg.lif)
    for li, layer in enumerate(model.layers):
        print(f"  layer {li}: {layer.n_dest} neurons -> "
              f"{len(layer.rounds)} round(s), "
              f"{layer.tables.n_rows} MEM_S&N rows")

    # 4. execute one input through the MX-NEURACORE chain
    res = run(model, spikes[0])
    ref = reference_forward([l.w_q for l in model.layers], snn_cfg.lif,
                            spikes[0])
    assert np.array_equal(res.out_spikes, ref), "HW twin != reference!"
    pred = res.out_spikes.sum(axis=0).argmax()
    print(f"prediction: class {pred} (label {labels[0]}), "
          f"bit-exact vs dense reference")

    # 5. energy report (calibrated Table-II model)
    e = res.energy
    print(f"energy: {e.tops_per_w:.2f} TOPS/W  "
          f"({e.total_ops} ops, util {e.utilization:.1%}, "
          f"dynamic {e.dynamic_j*1e9:.1f} nJ, static {e.static_j*1e9:.1f} nJ)")

    # 6. batched engine: the same memories over a whole batch, through the
    #    event_synapse and lif_update kernels
    batch = spikes[:8]
    packed = model.pack(device=dev)
    run_batched(packed, batch)              # first call: uploads, warms up
    sync()
    t0 = time.perf_counter()
    res_b = run_batched(packed, batch)
    sync()
    dt = time.perf_counter() - t0
    for b, oracle in enumerate(run_batch(model, batch)):
        assert np.array_equal(res_b.out_spikes[b], oracle.out_spikes), \
            f"batched engine != cycle-accurate twin on sample {b}!"
    assert np.array_equal(res_b.out_spikes[0], res.out_spikes)
    preds = res_b.out_spikes.sum(axis=1).argmax(axis=1)
    counts, _ = snn_forward_batch_major(
        [torch.from_numpy(l.w_q).to(dev) for l in model.layers],
        torch.from_numpy(batch).to(dev), snn_cfg)
    agree = float((counts.argmax(-1).cpu().numpy() == preds).mean())
    print(f"batched engine on {dev.type}: {len(batch)} samples in "
          f"{dt*1e3:.3f} ms (second call), preds {preds.tolist()} "
          f"(labels {labels[:8].tolist()}), {agree:.0%} agreement with the "
          f"training-graph forward")

    # 7. serving: variable-length requests, bucketed so the set of shapes
    #    stays bounded (every result still bit-exact vs the oracle)
    rng = np.random.default_rng(7)
    streams = [spikes[i, :rng.integers(5, 21)] for i in range(12)]
    policy = BucketPolicy(batch_sizes=(4, 8), time_steps=(10, 20))
    n0 = trace_count()
    served = run_bucketed(packed, streams, policy=policy)
    for i, r in enumerate(served):
        assert np.array_equal(r.out_spikes, run(model, streams[i]).out_spikes), \
            f"bucketed serving != cycle-accurate twin on request {i}!"
    print(f"served {len(streams)} requests of "
          f"{sorted({len(s) for s in streams})} steps in "
          f"{trace_count() - n0} new shape(s) "
          f"(<= {policy.n_buckets} buckets), all bit-exact")


if __name__ == "__main__":
    main()
