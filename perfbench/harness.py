"""Run one cell of the benchmark once and build its result line.

Everything is found by name: the cell's entry in ``BENCHMARK.json``, its
file ``perfbench/workloads/<cell>.json`` (the configuration's name, the
driver's kind and the traffic's parameters), the configuration's file
``perfbench/configs/<config>.json``, the driver ``perfbench/drivers/
<kind>.py`` and one reader ``perfbench/metrics/<metric>.py`` for every
metric.  A cell reports the end-to-end metrics (with ``trace`` off) or the
per-layer metrics (with it on) whose ``workloads`` list names it, or that
have no such list; a reader that finds nothing to read returns ``None``
and its metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench.drivers.common import sync

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell's driver (its set-up, window
    and reference), the run's settings and, with ``trace`` on, the
    trace's summary."""

    cell: object
    config: dict
    setup_s: float
    device: torch.device
    trace: object = None

    @property
    def on_chip(self) -> bool:
        return self.device.type == "cuda"


def load(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """The benchmark, the cell's entry in it, its file and its
    configuration."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cell = json.loads((root / "perfbench" / "workloads"
                       / f"{workload}.json").read_text())
    if cell["config"] != entry["config"]:
        raise SystemExit(f"perfbench: {workload}.json names config "
                         f"{cell['config']!r}, BENCHMARK.json {entry['config']!r}")
    cfg = json.loads((root / "perfbench" / "configs"
                      / f"{entry['config']}.json").read_text())
    return spec, entry, cell, cfg


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _module(kind: str, name: str, root: Path):
    """``perfbench/<kind>/<name>.py`` under ``root``, loaded by its path
    (names hold dots)."""
    path = root / "perfbench" / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    return _module("metrics", name, root).read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float | None = None,
        root: Path = ROOT) -> tuple[dict | None, str]:
    """Run ``workload`` once.  Returns the result line's object (None when
    the run may print none) and the text for standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    spec, entry, cellfile, cfg = load(workload, root)
    driver = _module("drivers", cellfile["driver"], root)
    cell = driver.Cell(cfg, cellfile["traffic"], seed, device, trace)
    cell.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start

    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from perfbench.trace import summarize
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("window"):
                cell.window(seconds)
                sync(device)
        summary = summarize(prof)
        del prof
    else:
        cell.window(seconds)
        sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = cell.check()

    loaded = forbidden_modules()
    if loaded:
        return None, f"perfbench: the process loaded {', '.join(loaded)}"

    ctx = Run(cell=cell, config=cfg, setup_s=setup_s, device=device,
              trace=summary)
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    checks = checked["checks"]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(checked["attempted"]),
              "failed": int(checked["failed"]), "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    err = "\n".join(f"check {k}: {v} (limit {lim})"
                    for k, (v, lim) in checks.items())
    return result, err
