"""LM training launcher, in PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --steps 1000 --mesh 1,1 [--seq 4096] [--batch 4] [--smoke] \
      [--compress] [--ckpt DIR] [--checkpoint-every 200] \
      [--spoof-devices N] [--device cuda|cpu]

Parameters are float32, seeded (``bundle.init(seed=0)``); batches come from
the synthetic token pipeline (:func:`repro_torch.data.tokens.token_batch`,
step-keyed, so a resumed run sees the batches an uninterrupted one would).
The step is :func:`~repro_torch.engine.train_loop.make_train_step` on the
bundle's loss (every layer body rematerialised) with AdamW.  ``--mesh d,m``
trains on a ``("data", "model")`` mesh of the first ``d * m`` devices
(fewer raise), or of ``d * m`` shards of one device with
``--spoof-devices N``, under the training rules: the dense layers run on
the mesh's first device, where the parameters and optimiser state live;
the MoE shards its experts over ``model``.  With ``--ckpt DIR`` the loop
checkpoints every ``--checkpoint-every`` steps and at the end, and resumes
from the latest checkpoint in ``DIR``, written under any mesh; without
``--ckpt``, or with ``--checkpoint-every 0``, nothing is written.
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.common import ArchConfig
from repro_torch.core.pytree import tree_leaves
from repro_torch.data.tokens import TokenPipelineConfig, token_batch
from repro_torch.engine.train_loop import (TrainLoopConfig, init_train_state,
                                           make_train_step, resume_or_init,
                                           train_loop)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import CompressionConfig
from repro_torch.parallel.sharding import TRAIN_RULES, activate


def batch_fn_for(cfg: ArchConfig, seq: int, batch: int, device):
    """``step -> batch`` on ``device``, as the JAX package's launcher builds
    them: the encoder-decoder family gets zero frames ``[B, seq, d_model]``
    and tokens cut to ``seq // decoder_ratio + 1``; a VLM backbone zero
    ``image_embeds``; every family the token pipeline's ``[B, seq + 1]``
    tokens of that step."""
    data_cfg = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch)

    def batch_fn(step: int) -> dict:
        toks = torch.from_numpy(token_batch(data_cfg, step)["tokens"])
        if cfg.family == "encdec":
            return {"frames": torch.zeros((batch, seq, cfg.d_model),
                                          device=device),
                    "tokens": toks[:, :seq // cfg.decoder_ratio + 1].to(
                        device)}
        b = {"tokens": toks.to(device)}
        if cfg.n_image_embeds:
            b["image_embeds"] = torch.zeros(
                (batch, cfg.n_image_embeds, cfg.d_model), device=device)
        return b

    return batch_fn


def train(arch: str | ArchConfig, *, steps: int = 1000,
          mesh: tuple[int, int] = (1, 1), seq: int = 0, batch: int = 0,
          lr: float = 3e-4, warmup_steps: int | None = None,
          smoke: bool = False, compress: bool = False,
          ckpt: str | None = None, checkpoint_every: int = 200,
          log_every: int = 10, device="cuda",
          spoof_devices: int | None = None,
          log_fn: Callable[[str], None] = print):
    """Train ``arch`` (a registry name, or an :class:`ArchConfig`) for
    ``steps`` steps, resuming from ``ckpt`` when it holds a checkpoint.
    ``seq`` and ``batch`` of 0 take ``train_4k``'s (64 and 8 with
    ``smoke``).  ``warmup_steps`` of None keeps :class:`AdamWConfig`'s.
    Returns ``(state, hist)``: the final state tree (``params``, ``opt``
    and, with ``compress``, ``residual``, on the mesh's first device) and
    the loop's history (``loss``, ``step_time``, ``stragglers``,
    ``checkpoints``, ``grad_norm``, ``lr``) with ``start``, the step it
    began at."""
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES["train_4k"]
    seq = seq or (64 if smoke else shape.seq_len)
    batch = batch or (8 if smoke else shape.global_batch)
    m = make_mesh(tuple(mesh), ("data", "model"), device=device,
                  spoof=spoof_devices)
    dev = m.devices[0]
    bundle = build_model(cfg)
    opt_cfg = AdamWConfig(lr=lr) if warmup_steps is None else AdamWConfig(
        lr=lr, warmup_steps=warmup_steps)
    comp = CompressionConfig(enabled=compress)
    with activate(m, TRAIN_RULES):
        params = bundle.init(seed=0, device=dev)
        n = sum(p.numel() for p in tree_leaves(params))
        log_fn(f"{cfg.name}: {n / 1e6:.1f}M params, mesh {m.dims}, "
               f"batch {batch} x seq {seq}")
        state = init_train_state(None, params, opt_cfg, comp).as_tree()
        del params
        step_fn = make_train_step(bundle.loss, opt_cfg, comp)
        loop_cfg = TrainLoopConfig(
            steps=steps, checkpoint_every=checkpoint_every,
            checkpoint_dir=ckpt if checkpoint_every > 0 else None,
            log_every=log_every)
        start = 0
        if loop_cfg.checkpoint_dir:
            state, start = resume_or_init(loop_cfg, state, device=dev)
        if start:
            log_fn(f"resumed from step {start}")
        # the loop gets the only reference to the state, so that each
        # step's new state replaces the old one (a reference kept here
        # would hold the first state, 22.7 GB at InternLM2-1.8B, to the end)
        box = [state]
        del state
        state, hist = train_loop(box.pop(), step_fn,
                                 batch_fn_for(cfg, seq, batch, dev),
                                 loop_cfg, start_step=start, log_fn=log_fn)
    hist["start"] = start
    return state, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--mesh", default="1,1", help="data,model")
    ap.add_argument("--seq", type=int, default=0, help="0 = train_4k shape")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (none: no checkpoints)")
    ap.add_argument("--checkpoint-every", type=int, default=200)
    ap.add_argument("--spoof-devices", type=int, default=None,
                    help="shards of the mesh on one device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dm, mm = (int(x) for x in args.mesh.split(","))
    state, hist = train(args.arch, steps=args.steps, mesh=(dm, mm),
                        seq=args.seq, batch=args.batch, lr=args.lr,
                        smoke=args.smoke, compress=args.compress,
                        ckpt=args.ckpt,
                        checkpoint_every=args.checkpoint_every,
                        device=args.device, spoof_devices=args.spoof_devices)
    if hist["loss"]:
        print(f"final loss {hist['loss'][-1]:.4f}; "
              f"checkpoints: {hist['checkpoints']}")
    return state, hist


if __name__ == "__main__":
    main()
