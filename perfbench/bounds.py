"""Spreads and bounds from two sets of runs of one cell.

    python3 perfbench/bounds.py A1.out ... A6.out -- B1.out ... B6.out

Each file holds a run's standard output; its last line is the result.
For each metric it prints both sets' medians and spreads (first to third
quartile over the median, ``statistics.quantiles(values, n=4)``), the
bound the benchmark's rule gives (five times the wider spread, at least
1 % and at most 25 %; ``setup_s`` takes 25 % whatever its spread), and the
spread a check holds a bound's tightness to: the mean of the two sets'
spreads, each without its run farthest from its median, which may not
pass half the bound.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.stats import spread  # noqa: E402


def values(paths) -> dict:
    out: dict = {}
    for p in paths:
        with open(p) as f:
            res = json.loads(f.read().strip().splitlines()[-1])
        for name, m in res["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def trimmed(values) -> float:
    """The spread without the run farthest from the median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index("--")
    a, b = values(argv[:cut]), values(argv[cut + 1:])
    for name in a:
        sa, sb = spread(a[name]), spread(b[name])
        bound = 0.25 if name == "setup_s" else \
            min(0.25, max(0.01, 5 * max(sa, sb)))
        tight = 0.5 * (trimmed(a[name]) + trimmed(b[name]))
        print(f"{name}: median {statistics.median(a[name])} / "
              f"{statistics.median(b[name])}, spread {sa:.5f} / {sb:.5f}, "
              f"bound {bound:.3f}, trimmed spread {tight:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
