"""Find a stream cell's knee: one set-up, then the cell's window at each of
several offered rates, on the card.

    python3 perfbench/sweep.py --workload cifar10dvs_mlp.stream \
        --rates 100,200,300 --seconds 10 --seed 1 [--out sweep.json]

For each rate it prints the requests offered, rejected and completed, the
share answered within the slack, p50 and p99 latency (ms), the deepest
queue, and how late the generator ran.  The knee is the highest rate with
no rejection and a queue that does not grow: the generator never falls a
slack behind and the p99 stays within twice the slack.  (The server
dispatches a partial group at its deadline less the estimated service
time, so some requests land just past their deadline at every rate: the
share within the slack is reported, not required.)  The cell runs at four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import prepare
    prepare()

    import numpy as np
    import torch
    from perfbench import harness
    from perfbench.stats import percentile_ms

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    _, _, cellfile, cfg = harness.load(args.workload)
    cell = harness._module("drivers", cellfile["driver"], ROOT).Cell(
        cfg, dict(cellfile["traffic"]), args.seed, "cuda")
    cell.setup()
    slack = cell.traffic["slack"]
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        cell.server.metrics.max_queue_depth = 0
        cell.window(args.seconds)
        lat = cell.latency
        row = dict(rate=rate, offered=len(lat),
                   rejected=int(cell.rejected.sum()),
                   completed=int(np.isfinite(lat).sum() - cell.rejected.sum()),
                   within_slack=float(np.mean(lat <= slack)),
                   p50_ms=percentile_ms(lat, 50), p99_ms=percentile_ms(lat, 99),
                   max_queue=cell.server.metrics.max_queue_depth,
                   late_s=cell.lateness_s, window_s=cell.window_s)
        rows.append(row)
        print("sweep: " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
    ok = [r["rate"] for r in rows if r["rejected"] == 0
          and r["late_s"] < slack and r["p99_ms"] < 2e3 * slack]
    knee = max(ok) if ok else None
    print(f"knee: {knee} requests/s; cell rate {knee and 0.8 * knee}",
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(rows=rows, knee=knee,
                                                  device=torch.cuda.get_device_name())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
