"""The dry-run's cells as markdown tables: what ``python -m
repro_torch.launch.dryrun --all [--multi-pod] --out DIR`` wrote under
``DIR/{pod,multipod}/``.

    python tools/torch_dryrun_table.py DIR [--before OLD_DIR]

Prints a table of architecture x shape cells, the meshes found under DIR
side by side (pod / multipod): each cell's dominant roofline term (M
memory, X collective, C compute) and its bound in ms, the useful ratio
(model FLOPs over counted FLOPs) and the first device's argument bytes in
GB.  With ``--before``, a second table
lists every pod cell whose counted FLOPs differ between OLD_DIR and DIR,
with both counts and the change, and names the cells whose dot FLOPs,
bytes, collectives or memory differ.
"""

from __future__ import annotations

import argparse
import json
import os

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
TERM = {"memory": "M", "collective": "X", "compute": "C"}


def load(root: str, tag: str) -> dict[tuple[str, str], dict]:
    """``(arch, shape) -> record`` of the cells under ``root/tag``."""
    out, d = {}, os.path.join(root, tag)
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            out[rec["arch"], rec["shape"]] = rec
    return out


def cell(recs: list) -> str:
    """One cell on each mesh, ``/`` between the meshes: the dominant term
    and its bound, the useful ratio, and the first device's argument
    bytes (the same on every mesh)."""
    if recs[0] is None:
        return "—"
    bound = " / ".join(f"{TERM[r['roofline']['dominant']]} "
                       f"{r['roofline']['step_time_s'] * 1e3:.4g}"
                       for r in recs)
    useful = " / ".join(f"{r['useful_ratio']:.3f}" for r in recs)
    gb = recs[0]["memory"]["argument_size_in_bytes"] / 1e9
    return f"{bound} ms, {useful}, {gb:.1f} GB"


def table(meshes: list[dict]) -> list[str]:
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    for arch in sorted({a for a, _ in meshes[0]}):
        lines.append(f"| {arch} | " + " | ".join(
            cell([m.get((arch, s)) for m in meshes]) for s in SHAPES) + " |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    meshes = [m for m in (load(args.root, t) for t in ("pod", "multipod"))
              if m]
    print(" / ".join(f"{tuple(next(iter(m.values()))['mesh'])}: "
                     f"{len(m)} cells" for m in meshes))
    print("\n".join(table(meshes)) + "\n")
    if args.before:
        old, new = load(args.before, "pod"), load(args.root, "pod")
        print("| cell | flops before | flops after | change |")
        print("|---|---|---|---|")
        for key in sorted(new):
            a = old[key]["loop_aware"]["flops"]
            b = new[key]["loop_aware"]["flops"]
            if a != b:
                print(f"| {key[0]} {key[1]} | {a:.6g} | {b:.6g} | "
                      f"+{b - a:.4g} ({(b - a) / a:.3e} of it) |")
        same = sum(old[k]["loop_aware"]["flops"]
                   == new[k]["loop_aware"]["flops"] for k in new)
        others = [k for k in new if any(
            old[k][f] != new[k][f] for f in ("collectives", "memory"))
            or old[k]["loop_aware"]["dot_flops"]
            != new[k]["loop_aware"]["dot_flops"]
            or old[k]["loop_aware"]["bytes"] != new[k]["loop_aware"]["bytes"]]
        print(f"\ndot FLOPs, bytes, collectives and memory differ in "
              f"{len(others)} cells {others}")
        print(f"\n{same} of {len(new)} cells unchanged")


if __name__ == "__main__":
    main()
