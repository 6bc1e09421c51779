#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's LIF kernel (``lif_scan``) on one NVIDIA GPU:
this checkout's and, with ``--parent``, another checkout's, in turns
(parent, this, this, parent), each in a process of its own with its own
build of the kernels.

    python3 tools/torch_lif_bench.py [--parent DIR] [--out FILE]

DIR is a checkout of another commit, for example the parent unpacked with
``git archive HEAD^ | tar -x -C build/parent`` (``build/`` is not
committed).  For each shape of SHAPES, each checkout and each turn it
prints one ``lif:`` line:

  device_us        the kernel's device time per launch: the bare C entry
                   on a preallocated output, 200 launches, the mean kernel
                   duration in a torch.profiler trace
  device_event_us  CUDA events around 200 back-to-back launches, per
                   launch: the device time only while the device, not the
                   host, is the slower side
  issue_us         the host's time per ``ops.lif_scan`` call, 200 calls
                   issued without a sync
  floor_us         the launch floor: an empty kernel of the same grid,
                   timed as device_us (None for a checkout without one)

(chip_smoke.py's ``lif_timing`` takes each measurement.)

Every checkout's kernel is first checked bit for bit against its plain
version at the shape.  The card's name and power limit come first, and
``--out`` also writes every line as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8, 16, 1024), (8, 32, 1024), (8, 16, 512), (8, 16, 200),
          (8, 16, 10))
SEED = 0


def measure(tag: str, turn: int) -> list[dict]:
    """This process's checkout (first on sys.path) at every shape."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.lif import LIFParams
    from repro_torch.kernels import lif_update as lu
    from repro_torch.kernels import ops

    lif = LIFParams(beta=0.9, threshold=1.0)
    rows = []
    for b, t, n in SHAPES:
        rng = np.random.default_rng(SEED + n + t)
        cur = torch.from_numpy(rng.normal(0.3, 0.6, (b, t, n))
                               .astype(np.float32)).cuda()
        if not torch.equal(ops.lif_scan(cur, lif),
                           lu.lif_scan_plain(cur, lif)):
            raise SystemExit(f"FAILED: {tag} lif_scan at {b}x{t}x{n}")
        rows.append(dict(tree=tag, turn=turn, shape=f"{b}x{t}x{n}",
                         **cs.lif_timing(cur, lif),
                         bound_us=2 * cur.numel() * 4 / cs.HBM_BYTES_PER_S
                         * 1e6))
    return rows


def worker(tree: Path, tag: str, turn: int) -> None:
    sys.path.insert(0, str(ROOT))           # chip_smoke's timing helpers
    sys.path.insert(0, str(tree / "src"))   # the checkout under test
    for row in measure(tag, turn):
        print("ROW " + json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker.resolve(), args.tag, args.turn)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_lif_bench: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = [("this", ROOT)]
    if args.parent is not None:
        parent = ("parent", args.parent.resolve())
        trees = [parent, trees[0], trees[0], parent]
    rows, turns = [], {}
    for tag, tree in trees:
        turns[tag] = turns.get(tag, 0) + 1
        env = dict(os.environ, REPRO_TORCH_BUILD=str(
            ROOT / "build" / "lif_bench" / tag))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(tree), "--tag", tag, "--turn", str(turns[tag])],
            capture_output=True, text=True, env=env,
            timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for ln in proc.stdout.splitlines():
            if ln.startswith("ROW "):
                row = json.loads(ln[4:])
                rows.append(row)
                print("lif: " + " ".join(
                    f"{k}={round(v, 4) if isinstance(v, float) else v}"
                    for k, v in row.items()), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
