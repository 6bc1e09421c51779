"""Serving example, in PyTorch (the twin of examples/serve_lm.py):
prefill + batched greedy decode with a KV cache on a decoder-only
architecture (reduced config), the SWA ring buffer included.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral_8x7b \
      --tokens 32 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import _fit
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise SystemExit("this example drives the decoder-only serving path")
    bundle = build_model(cfg)
    params = bundle.init(seed=0, dtype=torch.bfloat16, device=args.device)
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)

    # prefill
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, {"tokens": prompt})
    _sync(dev)
    print(f"prefill({args.prompt_len} toks x {args.batch}): "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")

    # grow the self-cache to the full horizon (a ring buffer keeps its
    # window)
    spec, _ = bundle.cache_spec(args.batch, args.prompt_len + args.tokens)
    cache = {k: _fit(cache[k], s.shape) for k, s in spec.items()}

    toks = torch.argmax(logits, dim=-1)
    out = [toks]
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        logits, cache = bundle.decode(params, cache, {
            "tokens": toks, "pos": args.prompt_len + i})
        toks = torch.argmax(logits, dim=-1)
        out.append(toks)
    _sync(dev)
    dt = time.perf_counter() - t0
    seq = torch.stack(out, dim=1).cpu()
    print(f"decoded {args.tokens - 1} steps x {args.batch} seqs in "
          f"{dt * 1e3:.0f} ms ({dt / max(args.tokens - 1, 1) * 1e3:.1f} "
          f"ms/step)")
    print(f"sample continuation (batch 0): {seq[0][:16].tolist()}")


if __name__ == "__main__":
    main()
