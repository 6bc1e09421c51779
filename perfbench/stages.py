"""Run one cell once, as ``run.py`` does, and report every metric that has
a reading (end to end and per layer, traced or not); traced, also name
each idle gap of the card by the innermost span the host was in, at any
depth, the program's stage spans included.

    python3 perfbench/stages.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--out stages.jsonl]

The result's ``breakdown`` names gaps by the harness's spans alone; here
``stages`` adds, from the same trace: ``idle_gaps`` by the innermost span;
for each harness span, its idle seconds and the share of them inside a
program span (``named``); each span's mean ms and count in the window; and
the card's events that carry a span's name.  The traced run's end-to-end
metrics against an untraced run on the same seed give the cost of
tracing.  Against a program without stage spans it names gaps by the
harness's spans at any depth.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def innermost(spans, gaps) -> list:
    """For each gap ``(start, end)`` (ascending), the chain of spans
    ``(start, end, name)`` that holds its middle, outermost first.  Spans
    on the host's one thread nest, so one sweep with a stack does."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    stack, i, chains = [], 0, []
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        chains.append([sp[2] for sp in stack])
    return chains


def analyse(prof, summary, stage_names) -> dict:
    from torch.autograd import DeviceType

    from perfbench.trace import SPANS
    harness_names = set(SPANS) - {"window"}
    names = harness_names | set(stage_names)
    lo, hi = summary.window
    spans, on_card, per_span = [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name not in names:
            continue
        if ev.device_type() == DeviceType.CUDA:
            on_card[name] = on_card.get(name, 0) + 1
            continue
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        spans.append((s, e, name))
        if lo <= s and e <= hi:
            tot = per_span.setdefault(name, [0.0, 0])
            tot[0] += e - s
            tot[1] += 1
    gaps, t = [], lo
    for s, e in summary.busy():
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    by_inner: dict = {}
    by_harness: dict = {}
    for (s, e), chain in zip(gaps, innermost(spans, gaps)):
        inner = chain[-1] if chain else "host"
        by_inner[inner] = by_inner.get(inner, 0.0) + (e - s)
        outer = next((n for n in reversed(chain) if n in harness_names),
                     "host")
        row = by_harness.setdefault(outer, [0.0, 0.0])
        row[0] += e - s
        row[1] += (e - s) if inner in stage_names else 0.0
    return {
        "idle_gaps": sorted(([n, v] for n, v in by_inner.items()),
                            key=lambda kv: -kv[1]),
        "idle_in_harness_span": {n: {"idle_s": v[0], "named": v[1] / v[0]}
                                 for n, v in by_harness.items() if v[0] > 0},
        "span_ms": {n: [1e3 * v[0] / v[1], v[1]]
                    for n, v in per_span.items()},
        "on_card": on_card,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import prepare
    prepare()

    from perfbench import harness, trace
    from repro_torch.engine import tracing

    stage_names = getattr(tracing, "STAGE_SPANS", ())
    found: dict = {}
    summarize, metrics_for = trace.summarize, harness.metrics_for

    def summarize_and_analyse(prof):
        summary = summarize(prof)
        found.update(analyse(prof, summary, stage_names))
        return summary

    trace.summarize = summarize_and_analyse
    harness.metrics_for = lambda spec, w, traced: \
        metrics_for(spec, w, False) + metrics_for(spec, w, True)
    try:
        result, err = harness.run(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device=args.device,
                                  t_start=T_START, root=ROOT)
    finally:
        trace.summarize, harness.metrics_for = summarize, metrics_for
    if result is None:
        print(err, file=sys.stderr)
        return 3
    if found:
        result["stages"] = found
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       "trace": args.trace, **result})
    print(line, flush=True)
    print(err, file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
