"""LM serving launcher, in PyTorch: prefill, then batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \
      --smoke --requests 8 --prompt-len 16 --gen 16 [--mesh 1,1] [--sp] \
      [--spoof-devices N] [--device cuda|cpu]

Weights are seeded (``bundle.init(seed=0)``, bf16); prompts come from the
synthetic token pipeline (:func:`repro_torch.data.tokens.token_batch`,
seed 1).  ``--mesh d,m`` serves on a ``("data", "model")`` mesh of the
first ``d * m`` devices (fewer raise), or of ``d * m`` shards of one
device with ``--spoof-devices N``; prefill and decode run under the
decode rules, the MoE sharded over ``model``.  ``--sp`` activates
sequence-parallel flash-decoding (the cache's sequence over ``model``).
``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipelineConfig, token_batch
from repro_torch.device import capture_graph
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelBundle, build_model
from repro_torch.parallel.decode import make_sp_attention
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import (DECODE_RULES, DECODE_RULES_SP,
                                           activate)
from repro_torch.stage_spans import span


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fit(t: torch.Tensor, shape) -> torch.Tensor:
    """Pad/trim the seq dim (axis 3) of a cache tensor to match shape."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    if t.dim() == 5 and tuple(t.shape[:3]) == shape[:3]:
        d = shape[3] - t.shape[3]
        if d > 0:
            return F.pad(t, (0, 0, 0, d))
        return t[:, :, :, :shape[3]]
    return torch.zeros(shape, dtype=t.dtype, device=t.device)


def prompts_for(cfg, requests: int, prompt_len: int) -> np.ndarray:
    """``requests`` prompts of ``prompt_len`` tokens [B, S] int32 from the
    token pipeline (seed 1, step 0)."""
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                               global_batch=requests, seed=1)
    return token_batch(pipe, 0)["tokens"][:, :prompt_len]


@torch.no_grad()
def serve(bundle: ModelBundle, params: dict, prompts: torch.Tensor,
          gen: int, frames: torch.Tensor | None = None, *,
          mesh: Mesh | None = None, sp: bool = False) -> dict:
    """Prefill ``prompts`` [B, S] (on the parameters' device), pad the cache
    to the horizon S + gen, and decode greedily until each request has
    ``gen`` tokens (the prefill's argmax, then ``gen - 1`` decode steps).
    The ``encdec`` family also encodes ``frames`` [B, S_enc, d_model]; by
    default zeros of ``S * decoder_ratio`` frames, as the JAX package's
    launcher builds them.  Its cross cache is then padded with zero keys
    up to ``cross_len``, or trimmed, and decode attends to every slot.

    With a ``mesh`` (``("data", "model")``; the parameters on its first
    device), prefill and decode run under ``DECODE_RULES``, or with ``sp``
    under ``DECODE_RULES_SP`` and, where the model axis has more than one
    shard, decode attends through :func:`make_sp_attention`.

    The decode loop keeps every token on the device and reads them back
    once, after the last step.  On a card, without a mesh, a model whose
    ``bundle.graph_decode()`` allows it replays its decode steps from one
    CUDA graph (:func:`_graphed_decode`).  The prefill and each decode
    step are the stage spans ``lm.prefill`` and ``lm.decode_step``.
    Returns ``tokens`` [B, gen] (numpy), the prefill's and the decode
    loop's seconds, and ``logits``, the last step's logits (on the
    device)."""
    if mesh is None:
        if sp:
            raise ValueError("sequence-parallel decode needs a mesh")
        return _serve(bundle, params, prompts, gen, frames, None,
                      graphed=True)
    attn = (make_sp_attention(mesh) if sp and mesh.shape["model"] > 1
            else None)
    with activate(mesh, DECODE_RULES_SP if sp else DECODE_RULES):
        return _serve(bundle, params, prompts, gen, frames, attn)


def _graphed_decode(bundle, params, cache, outs, s, gen) -> torch.Tensor:
    """The greedy decode loop with its steps replayed from one CUDA graph:
    the first step runs eagerly (it warms the step's launchers), then one
    step, with its argmax fed back as the next token and the position
    advanced on the card, is captured
    (:func:`~repro_torch.device.capture_graph`) and replayed ``gen - 2``
    times.  Appends each step's tokens to ``outs``; returns
    the last step's logits."""
    dev = outs[0].device
    tok = outs[0].clone()
    pos = torch.full((), s, dtype=torch.int64, device=dev)

    def step():
        logits, _ = bundle.decode(params, cache, {"tokens": tok, "pos": pos})
        tok.copy_(torch.argmax(logits, dim=-1))
        pos.add_(1)
        return logits

    with span("lm.decode_step"):
        step()
    outs.append(tok.clone())
    graph, logits = capture_graph(step, dev)
    for _ in range(gen - 2):
        with span("lm.decode_step"):
            graph.replay()
        outs.append(tok.clone())
    return logits.clone()


def _serve(bundle, params, prompts, gen, frames, attn,
           graphed=False) -> dict:
    cfg = bundle.cfg
    dev = params["embed"].device
    b, s = prompts.shape
    batch = {"tokens": prompts}
    if cfg.family == "encdec":
        batch["frames"] = frames if frames is not None else torch.zeros(
            (b, s * cfg.decoder_ratio, cfg.d_model), device=dev)
    if cfg.n_image_embeds:
        batch["image_embeds"] = torch.zeros(
            (b, cfg.n_image_embeds, cfg.d_model), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    with span("lm.prefill"):
        logits, cache = bundle.prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    spec, _ = bundle.cache_spec(b, s + gen)
    cache = {k: _fit(cache[k], sp.shape).to(sp.dtype) for k, sp in
             spec.items()}
    toks = torch.argmax(logits, dim=-1)
    outs = [toks]
    t0 = time.perf_counter()
    if graphed and dev.type == "cuda" and gen > 2 and bundle.graph_decode():
        logits = _graphed_decode(bundle, params, cache, outs, s, gen)
    else:
        kw = {} if attn is None else {"attn_impl": attn}
        for i in range(gen - 1):
            with span("lm.decode_step"):
                logits, cache = bundle.decode(params, cache,
                                              {"tokens": toks, "pos": s + i},
                                              **kw)
            toks = torch.argmax(logits, dim=-1)
            outs.append(toks)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(outs, 1).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s, "logits": logits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--spoof-devices", type=int, default=None,
                    help="shards of the mesh on one device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dm, mm = (int(x) for x in args.mesh.split(","))
    mesh = make_mesh((dm, mm), ("data", "model"), device=args.device,
                     spoof=args.spoof_devices)
    dev = mesh.devices[0]
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build_model(cfg)
    params = bundle.init(seed=0, dtype=torch.bfloat16, device=dev)
    prompts = torch.from_numpy(
        prompts_for(cfg, args.requests, args.prompt_len)).to(dev)
    out = serve(bundle, params, prompts, args.gen, mesh=mesh, sp=args.sp)
    steps = max(args.gen - 1, 1)
    print(f"prefill: {out['prefill_s'] * 1e3:.0f} ms")
    print(f"decoded {args.gen - 1} x {args.requests} in "
          f"{out['decode_s'] * 1e3:.0f} ms "
          f"({out['decode_s'] / steps * 1e3:.1f} ms/step)")
    print(f"sample: {out['tokens'][0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
