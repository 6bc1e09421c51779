#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh phase alone on the GPUs of this host: a
real 2-way mesh (``cuda:0``, ``cuda:1``) where there are two or more
cards, else two spoofed shards of the one.

    python3 tools/torch_mesh_smoke.py

It builds the kernels, takes the native-width CIFAR10-DVS MLP on Accel_2
and its 8 requests from ``chip_smoke.cifar_model`` (the main run's own
setup), packed on ``cuda:0`` on both routes, and calls
``chip_smoke.phase_mesh``: the ``mesh:``, ``mesh_serve:``, ``mesh_chaos:``
and ``mesh_train:`` lines, every check of the phase raising on failure.
The card's name and power limit come first.  Use it to see the mesh on a multi-card host without the
rest of the smoke run (about 2 minutes of command).
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
        print("torch_mesh_smoke: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    m = cs.cifar_model(dev)
    mapped, streams = m["mapped"], m["streams"]
    routes = {"dense": m["dense"], "packed": m["packed"]}
    t0 = time.perf_counter()
    lines, _ = cs.phase_mesh(dev, card, mapped, routes, streams)
    for name, fields in lines:
        cs.log(name, **fields)
    cs.log("timing", mesh=round(time.perf_counter() - t0, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
