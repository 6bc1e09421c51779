#!/usr/bin/env python3
"""What rematerialisation buys on one card: InternLM2-1.8B at full width
(float32 parameters, seeded; bf16 activations), one AdamW train step on
a batch of 4 x 4096 tokens (train_4k's sequence), with every layer
rematerialised (``bundle.loss``) and with every layer's activations kept
(``remat=False``; each q chunk of the attention is rematerialised in
both), at a few depths.

    python3 tools/torch_lm_train_remat.py [--layers 1,2,24] [--seq 4096]

One line a run: its peak device memory above the resident state
(parameters and AdamW moments) and the step's seconds (the first run
includes warm-up), or, where the card runs out of memory, the first line
of the error.  Then the card's name and power limit (``nvidia-smi``).
Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def loss_fn(cfg, remat: bool):
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import cross_entropy

    def loss(params, batch):
        toks = batch["tokens"]
        logits, aux = T.transformer_logits(params, cfg, toks[:, :-1],
                                           remat=remat)
        return cross_entropy(logits, toks[:, 1:]) + 0.01 * aux

    return loss


def one_step(cfg, state, batch, remat: bool) -> str:
    from repro_torch.engine.train_loop import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    step = make_train_step(loss_fn(cfg, remat), AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        new, metrics = step(state, batch)
        loss = metrics["loss"].item()
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e).splitlines()[0]
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        return f"out_of_memory peak_mib={peak:.1f} error={msg!r}"
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    del new
    return f"loss={loss:.6f} peak_mib={peak:.1f} seconds={seconds:.3f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="1,2,24")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_train_remat: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.engine.train_loop import init_train_state
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    dev = torch.device("cuda")
    full = get_config("internlm2_1_8b")
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(full, n_layers=n)
        state = init_train_state(None, build_model(cfg).init(
            seed=0, device=dev), AdamWConfig()).as_tree()
        batch = batch_fn_for(cfg, args.seq, args.batch, dev)(0)
        for remat in (True, False):
            print(f"remat: layers={n} batch={args.batch} seq={args.seq} "
                  f"remat={remat} {one_step(cfg, state, batch, remat)}",
                  flush=True)
        del state, batch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
