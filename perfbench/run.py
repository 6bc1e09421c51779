"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository.  The last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``,
with the device's busy time and the trace's ``breakdown``), the ``device``
and, last, each number the correctness check compared with its limit;
the same numbers end standard error.  The run exits non-zero and prints
no result without a CUDA card (or with fewer than the cell asks for), and
when the process has loaded JAX or the JAX package by the window's close.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    and the program and the benchmark importable."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    prepare()
    import torch
    from perfbench import harness

    spec = harness.load(args.workload)[1]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec["chips"]):
        print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, err = harness.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    if result is None:
        print(err, file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(err, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
