"""What the serving drivers share: the reference run over the pool and the
comparison of every answer the window produced with it."""

from __future__ import annotations

import importlib

import numpy as np
import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference(cfg: dict, weights, frames: torch.Tensor, lengths,
              precision: str = "float32") -> dict:
    """The configuration's plain reference over the whole pool, on the
    pool's device, as host arrays sliced per request (``precision="tf32"``
    is the control)."""
    mod = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    out = mod.forward(frames, lengths, weights, cfg["quant_bits"], cfg["lif"],
                      precision=precision)
    ends = np.cumsum([int(t) for t in lengths])
    split = lambda x: np.split(x.cpu().numpy(), ends[:-1])   # noqa: E731
    return dict(raw=out, out=split(out["out"]),
                events=[split(e) for e in out["events"]],
                ops=[split(o) for o in out["ops"]])


def _differ(got, want: np.ndarray) -> int:
    """Entries of ``got`` that differ from ``want``; every entry of
    ``want`` when the shapes differ."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size) or 1
    return int(np.count_nonzero(got != want))


def compare(pairs, ref: dict, stats: bool) -> dict:
    """Hold each ``(pool index, result)`` pair to the reference: the output
    spikes entry by entry and, with ``stats``, each layer's events and
    synaptic operations a step.  ``None`` is an answer that never came.

    Returns the numbers compared, each with its limit (all exact), and the
    counts of answers attempted and failed."""
    wrong_spikes = wrong_counters = missing = attempted = failed = 0
    for i, res in pairs:
        attempted += 1
        if res is None:
            missing += 1
            failed += 1
            continue
        bad = _differ(res.out_spikes, ref["out"][i])
        badc = 0
        if stats:
            badc += abs(len(res.stats) - len(ref["events"]))
            for st, ev, op in zip(res.stats, ref["events"], ref["ops"]):
                badc += _differ(st.events, ev[i]) + _differ(st.engine_ops,
                                                           op[i])
        wrong_spikes += bad
        wrong_counters += badc
        failed += int(bad + badc > 0)
    checks = dict(wrong_spikes=(wrong_spikes, 0), missing=(missing, 0))
    if stats:
        checks["wrong_counters"] = (wrong_counters, 0)
    return dict(checks=checks, attempted=attempted, failed=failed)
