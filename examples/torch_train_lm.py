"""End-to-end LM training script, in PyTorch (the twin of
examples/train_lm.py): train a ~100M-param dense transformer for a few
hundred steps on the synthetic token pipeline, with the training loop
(checkpoint/restart, straggler detection, optional gradient compression)
on the card, or on a mesh of cards.

  PYTHONPATH=src python examples/torch_train_lm.py --size 100m --steps 200
  # tiny, on the CPU:
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
  # a (4, 2) mesh spoofed on one device:
  PYTHONPATH=src python examples/torch_train_lm.py --mesh 4,2 \
      --spoof-devices 8

``--ckpt DIR`` checkpoints every 100 steps and resumes from ``DIR``;
without it nothing is written.
"""

import argparse

from repro_torch.configs.common import ArchConfig
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--size", choices=["tiny", "100m"], default="tiny",
                    help="'100m' is the deliverable config (use on the "
                         "card); 'tiny' smoke-runs the same script on the "
                         "CPU")
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--spoof-devices", type=int, default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.size == "100m":
        # ~100M params: 12L x 768 (GPT-2-small-ish) with GQA
        cfg = ArchConfig(name="lm100m", family="dense", n_layers=12,
                         d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                         vocab_size=32000, head_dim=64)
    else:
        cfg = ArchConfig(name="lm-tiny", family="dense", n_layers=2,
                         d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                         vocab_size=2048, head_dim=32)
    dm, mm = (int(x) for x in args.mesh.split(","))
    _, hist = train(cfg, steps=args.steps, mesh=(dm, mm), seq=args.seq,
                    batch=args.batch, lr=3e-4, warmup_steps=50,
                    compress=args.compress, ckpt=args.ckpt,
                    checkpoint_every=100, log_every=20, device=args.device,
                    spoof_devices=args.spoof_devices)
    if hist["loss"]:
        print(f"done: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f},"
              f" {hist['stragglers']} straggler events, "
              f"checkpoints at {hist['checkpoints']}")


if __name__ == "__main__":
    main()
