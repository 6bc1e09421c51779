"""The LM serving cell's correctness check, sound and against its control,
on the card.

    python3 perfbench/lm_control.py --workload zamba2_7b.chat --seeds 1,2

For each seed: the cell's set-up, one timed call (the window's first,
whose tokens and logits the check keeps), its replay with the block
listener on, then the check's numbers twice over the same recorded
inputs: the program's blocks against the reference (the sound reading)
and the reference with every operand rounded to float8 e4m3, one
precision below the configuration's bf16, in the program's place (the
control, which has to come out not correct).  The limits are set between
the two.  Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, device="cuda",
             root: Path = ROOT) -> dict:
    import torch
    from perfbench import harness

    _, _, cellfile, cfg = harness.load(workload, root)
    mod = harness._module("drivers", cellfile["driver"], root)
    cell = mod.Cell(cfg, cellfile["traffic"], seed, torch.device(device))
    t0 = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t0
    cell.window(0.0)
    peak = (torch.cuda.max_memory_allocated()
            if cell.device.type == "cuda" else 0)
    out, rec = cell.record()
    t0 = time.perf_counter()
    sound = cell.gaps(rec, cell.kept[2])
    check_s = time.perf_counter() - t0
    ref = cell.reference()
    control = cell.gaps(rec, cell.kept[2], operand=ref.float8_e4m3)
    lim = cellfile["traffic"]["limits"]
    return {"seed": seed, "setup_s": setup_s, "call_s": sum(cell.calls[0][1:]),
            "prefill_s": cell.calls[0][1], "memory_peak_bytes": peak,
            "reference_s": check_s,
            "replay_tokens": int((out["tokens"] != cell.kept[1]).sum()),
            "sound": sound, "control": control, "limits": lim,
            "control_fails": any(control[k] > lim[k] for k in lim),
            "sound_passes": all(sound[k] <= lim[k] for k in lim)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.device)),
              flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
