"""End-to-end script in PyTorch (the twin of examples/train_snn.py): train
a MENAGE evaluation model through the port's SNN training engine
(`repro_torch.engine.snn_train`), then run the full prune -> quantize ->
map -> execute flow.

  --model mlp   (default) the paper's N-MNIST MLP (200/100/40/10) on Accel_1
  --model conv  the spiking CNN (conv->LIF->pool x2 + dense head) on the
                synthetic CIFAR10-DVS stream, lowered layer spec by layer
                spec (Conv2d with shared weight-SRAM words) onto Accel_2

Both families train through `train_snn_model`: AdamW through
`engine/train_loop.py`, step-keyed batches (a restart replays the exact
remaining data), resume-aware with `--ckpt DIR` (re-launching with the same
DIR continues from its last checkpoint; without it nothing is written),
data-parallel over a ("data",) mesh with `--data N` (the first N cards) or
`--spoof-devices N` (N shards of the one --device).  The gradient's fold is
pinned to 8 chunks, so a resume on another mesh size continues the same
loss trajectory bit for bit.

  PYTHONPATH=src python examples/torch_train_snn.py [--steps 300] \
      [--model conv] [--data 2 | --spoof-devices 8] [--ckpt DIR]
  PYTHONPATH=src python examples/torch_train_snn.py --device cpu --steps 20
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.menage_paper import (ACCEL_1, ACCEL_2, CIFAR_CONV,
                                              CIFAR_CONV_DATA, NMNIST_DATA,
                                              NMNIST_SNN)
from repro_torch.core.accelerator import map_model, run
from repro_torch.core.prune import prune_pytree
from repro_torch.core.quant import quantize_pytree
from repro_torch.data.events import event_batch_at, synthetic_event_dataset
from repro_torch.device import resolve_device
from repro_torch.engine import (BucketPolicy, SNNTrainConfig, model_for,
                                run_bucketed, snn_train_mesh, trace_count,
                                train_snn_model)
from repro_torch.snn.conv import conv_snn_forward, layer_specs
from repro_torch.snn.mlp import snn_forward


def _train(cfg, spikes, labels, n_test, args, dev, *, batch, name):
    """Training on ``dev`` or over the mesh the flags ask for,
    resume-aware."""
    mesh = None
    if args.data is not None or args.spoof_devices is not None:
        mesh = snn_train_mesh(args.data, device=dev,
                              spoof=args.spoof_devices)
        print(f"{name}: data-parallel over {mesh.size} device(s)"
              + ("" if mesh.real else " (spoofed)"))
    train_cfg = SNNTrainConfig(
        steps=args.steps, lr=1e-3, mesh=mesh, grad_shards=8,
        checkpoint_dir=None if args.ckpt is None else f"{args.ckpt}_{name}",
        checkpoint_every=100, log_every=50)

    def batch_of(step):
        return event_batch_at(spikes[n_test:], labels[n_test:], batch, step)

    params, hist = train_snn_model(
        model_for(cfg), cfg, batch_of, train_cfg,
        key=torch.Generator().manual_seed(1),
        device=None if mesh is not None else dev)
    if hist["loss"]:
        assert np.isfinite(hist["loss"][-1]), "training diverged"
        print(f"{name} train: loss={hist['loss'][-1]:.3f} "
              f"acc={hist['acc'][-1]:.2f} "
              f"(checkpoints at {hist['checkpoints']})")
    else:
        print(f"{name}: checkpoint already at step {train_cfg.steps} — "
              f"nothing left to train")
    return params


def _test_accuracy(forward, params, spikes, labels, cfg, dev) -> float:
    counts, _ = forward(params, torch.from_numpy(
        np.ascontiguousarray(spikes.swapaxes(0, 1))).to(dev), cfg)
    return float((counts.argmax(-1).cpu().numpy() == labels).mean())


def main_conv(args, dev):
    """Conv path: train, prune, lower to Conv2d/SumPool2d/Dense specs, map
    onto Accel_2, and hold the engine's kernels to the oracle."""
    cfg = CIFAR_CONV
    spikes, labels = synthetic_event_dataset(
        CIFAR_CONV_DATA, n_per_class=16, rng=np.random.default_rng(0))
    n_test = len(labels) // 5
    params = _train(cfg, spikes, labels, n_test, args, dev, batch=32,
                    name="conv")
    acc = _test_accuracy(conv_snn_forward, params, spikes[:n_test],
                         labels[:n_test], cfg, dev)
    print(f"conv test accuracy (before prune/quant): {acc:.3f}")

    pruned, _ = prune_pytree(params, 0.5)
    model = map_model(layer_specs(pruned, cfg), ACCEL_2, lif=cfg.lif)
    for li, layer in enumerate(model.layers):
        print(f"  layer {li}: {layer.n_src}->{layer.n_dest} "
              f"rounds={len(layer.rounds)} sram={layer.sram_bytes}B "
              f"(unique {layer.weight_bytes}B) shared={layer.shared_weights}")
    # serve the test clips through the bucketed engine (bounded shapes)
    policy = BucketPolicy(batch_sizes=(4,), time_steps=(cfg.num_steps,))
    n0 = trace_count()
    served = run_bucketed(model.pack(device=dev), list(spikes[:4]),
                          policy=policy)
    res = run(model, spikes[0])
    for b, r in enumerate(served):
        assert (r.out_spikes == run(model, spikes[b]).out_spikes).all(), \
            f"engine diverged from oracle on sample {b}"
    print(f"Accel_2 conv execution: {res.energy.tops_per_w:.2f} TOPS/W "
          f"(oracle == bucketed engine on {dev.type}, {len(served)} "
          f"samples, {trace_count() - n0} new shape(s))")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint prefix (DIR_mlp / DIR_conv); resumes "
                         "from it; none: nothing is written")
    ap.add_argument("--model", choices=("mlp", "conv"), default="mlp")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card (raises with no card); cpu: the "
                         "plain PyTorch path")
    ap.add_argument("--data", type=int, default=None,
                    help="train over a mesh of this many devices (the "
                         "first N cards, or of the --spoof-devices shards)")
    ap.add_argument("--spoof-devices", type=int, default=None,
                    help="make the mesh N logical shards of the one "
                         "--device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.model == "conv":
        return main_conv(args, dev)

    spikes, labels = synthetic_event_dataset(NMNIST_DATA, n_per_class=32,
                                             rng=np.random.default_rng(0))
    n_test = len(labels) // 5
    params = _train(NMNIST_SNN, spikes, labels, n_test, args, dev, batch=64,
                    name="mlp")
    acc = _test_accuracy(snn_forward, params, spikes[:n_test],
                         labels[:n_test], NMNIST_SNN, dev)
    print(f"test accuracy (before prune/quant): {acc:.3f}")

    pruned, _ = prune_pytree(params, 0.5)
    _, dq = quantize_pytree(pruned)
    acc_pq = _test_accuracy(snn_forward, dq, spikes[:n_test],
                            labels[:n_test], NMNIST_SNN, dev)
    print(f"test accuracy (after prune+quant):  {acc_pq:.3f} "
          f"(paper: 94.75% -> 94.1%)")

    model = map_model([w.cpu().numpy() for w in dq], ACCEL_1,
                      lif=NMNIST_SNN.lif)
    res = run(model, spikes[0])
    print(f"Accel_1 execution: {res.energy.tops_per_w:.2f} TOPS/W "
          f"(paper Table II: 3.4)")


if __name__ == "__main__":
    main()
