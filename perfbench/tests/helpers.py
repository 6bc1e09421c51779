"""A temporary checkout of the benchmark with a tiny configuration and its
cells added as files, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny_mlp", "source": "https://arxiv.org/abs/2410.08403",
    "model": "a small spiking MLP for tests on the CPU",
    "reference": "snn_mlp", "layer_sizes": [128, 48, 24, 10],
    "quant_bits": [8, 8, 8],
    "lif": {"beta": 0.9, "threshold": 1.0, "v_reset": 0.0,
            "surrogate_slope": 25.0},
    "accelerator": {"name": "tiny", "n_cores": 3, "n_engines": 4, "n_caps": 8,
                    "weight_mem_bytes": 1 << 20},
    "data": {"height": 8, "width": 8, "num_classes": 10, "base_rate": 0.03,
             "signal_rate": 0.5, "blobs_per_class": 5, "rate_map_seed": 1234},
    "prune_fraction": 0.5, "gain": 2.0,
}
POLICY = {"batch_sizes": [1, 4, 16], "time_steps": [8, 16, 32]}
CELLS = {
    "tiny_mlp.batch": {"config": "tiny_mlp", "driver": "batch", "traffic": {
        "requests_per_call": 32, "lengths": [8, 25], "pool_calls": 2,
        "with_stats": True, "policy": POLICY}},
    "tiny_mlp.batch_nostats": {"config": "tiny_mlp", "driver": "batch",
                               "traffic": {
        "requests_per_call": 32, "lengths": [8, 25], "pool_calls": 2,
        "with_stats": False, "policy": POLICY}},
    "tiny_mlp.stream": {"config": "tiny_mlp", "driver": "stream", "traffic": {
        "rate": 40.0, "slack": 0.25, "lengths": [8, 25], "pool_size": 32,
        "policy": POLICY}},
    "tiny_mlp.train": {"config": "tiny_mlp", "driver": "train", "traffic": {
        "batch": 8, "T": 10, "pool_size": 40, "lr": 1e-3, "b1": 0.9,
        "b2": 0.999, "eps": 1e-8,
        "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}},
}

# the cell of BENCHMARK.json whose metrics each tiny cell reports
TWINS = {"tiny_mlp.batch": "nmnist_mlp4.batch_nostats",
         "tiny_mlp.batch_nostats": "nmnist_mlp4.batch_nostats",
         "tiny_mlp.stream": "cifar10dvs_mlp.stream",
         "tiny_mlp.train": "cifar10dvs_mlp.train"}


def tiny_checkout(tmp: Path, bits: int = 8) -> Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied to ``tmp``, with the
    tiny configuration, its cells and a new per-layer metric added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = dict(TINY, quant_bits=[bits] * 3)
    (tmp / "perfbench/configs/tiny_mlp.json").write_text(json.dumps(cfg))
    for name, cell in CELLS.items():
        (tmp / f"perfbench/workloads/{name}.json").write_text(json.dumps(cell))
    (tmp / "perfbench/metrics/calls_in_window.py").write_text(
        "def read(run):\n    return len(run.cell.served)\n")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_mlp", "source": TINY["source"],
                            "file": "perfbench/configs/tiny_mlp.json",
                            "reduced": [], "why": "tests"})
    for name, cell in CELLS.items():
        spec["workloads"].append({"name": name, "config": "tiny_mlp",
                                  "traffic": name.split(".", 1)[1],
                                  "chips": 1,
                                  "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        for name, twin in TWINS.items():
            if twin in ws:
                ws.append(name)
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "front end", "moves": "requests_per_s",
                              "workloads": ["tiny_mlp.batch"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
