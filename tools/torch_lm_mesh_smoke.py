#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s LM mesh lines alone on the GPUs of this host,
the EP line on a (1, 4) mesh: real (``cuda:0`` to ``cuda:3``) where there
are four or more cards, else four spoofed shards of the one.

    python3 tools/torch_lm_mesh_smoke.py

``lm_moe_ep:`` serves Qwen3-MoE-235B-A22B at full width, 2 of 94 layers,
32 experts a shard, through ``serve(mesh=)`` (``chip_smoke.phase_lm_moe``
on (1, 4) instead of the main run's (2, 4)); ``lm_sp:`` InternLM2-1.8B
with SP decode on (1, 4) and ``pipeline:`` 4 DeepSeek-67B layers as 4
stages, as in the main run (``chip_smoke.phase_lm_sp``,
``phase_pipeline``), every check raising on failure.  On a real mesh the
parameters and the KV cache stay on ``cuda:0`` and each shard's slice is
copied to its card at every call; a line's profiled device time sums
over the cards.  No kernel is built.  The card's name and power limit
come first (about 1 minute of command).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_mesh_smoke: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.log("lm_moe_ep", **cs.phase_lm_moe("qwen3_moe_235b_a22b", (1, 4),
                                          dev, card, cs.SEED + 70))
    cs.log("lm_sp", **cs.phase_lm_sp(dev, card, cs.SEED + 74))
    cs.log("pipeline", **cs.phase_pipeline(dev, card, cs.SEED + 76))
    cs.log("timing", lm_mesh=round(time.perf_counter() - t0, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
