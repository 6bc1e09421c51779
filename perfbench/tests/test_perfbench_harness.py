"""The harness on the CPU, at a tiny size: cells, configurations and
metrics found as files, the result line's shape, the refusal without a
card, and ``correct`` coming out false under faults planted in the
program's timed path."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.helpers import REPO, tiny_checkout

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def run(root, workload, trace=False, seconds=1.0):
    return harness.run(workload, SEED, seconds, trace, device="cpu", root=root)


def test_added_files_are_found(root):
    res, _ = run(root, "tiny_mlp.batch", trace=True)
    assert res["correct"]
    # the new per-layer metric, read by its new reader file
    assert res["metrics"]["calls_in_window"]["value"] >= 1
    assert res["metrics"]["calls_in_window"]["unit"] == "calls"
    assert set(res["metrics"]) >= {"setup.map_s", "serving.useful_ratio",
                                   "engine.call_ms"}


@pytest.mark.parametrize("workload", ["tiny_mlp.batch",
                                      "tiny_mlp.batch_nostats"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(root, workload, trace):
    res, err = run(root, workload, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in harness.metrics_for(spec, workload, trace)}
    assert set(res["metrics"]) <= wanted
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][key]) <= 10
    else:
        assert set(res["metrics"]) == {"requests_per_s", "setup_s"}
        assert "breakdown" not in res
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    lines = err.splitlines()
    assert len(lines) == len(res["checks"])
    for line, (name, c) in zip(lines, res["checks"].items()):
        assert line == f"check {name}: {c['value']} (limit {c['limit']})"
    json.dumps(res, allow_nan=False)


def test_stream_cell(root):
    res, _ = run(root, "tiny_mlp.stream", seconds=1.5)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"latency_p99_ms", "setup_s"}
    p99 = res["metrics"]["latency_p99_ms"]["value"]
    res, _ = run(root, "tiny_mlp.stream", trace=True, seconds=1.5)
    assert 0 < res["metrics"]["latency_p50_ms"]["value"] <= 2 * p99
    assert 0 < res["metrics"]["server.fill"]["value"] <= 1
    assert res["metrics"]["server.ttfd_ms_mean"]["value"] > 0


def flip_one_spike(outs):
    outs[-1] = outs[-1].clone()
    outs[-1][0, 0, 0] = 1 - outs[-1][0, 0, 0]
    return outs


def drop_half_the_batch(outs):
    b = outs[-1].shape[0]
    outs[-1] = outs[-1].clone()
    outs[-1][b // 2:] = 0
    return outs


@pytest.mark.parametrize("workload", ["tiny_mlp.batch",
                                      "tiny_mlp.batch_nostats",
                                      "tiny_mlp.stream"])
@pytest.mark.parametrize("fault", [flip_one_spike, drop_half_the_batch])
def test_faults_fail_correct(root, monkeypatch, workload, fault):
    """An answer altered where it is produced, and half of the batch left
    out, each turn ``correct`` false."""
    from repro_torch.engine import batched_run as br
    real = br._forward_impl
    monkeypatch.setattr(br, "_forward_impl",
                        lambda *a, **k: fault(real(*a, **k)))
    res, err = run(root, workload, seconds=1.0)
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["wrong_spikes"]["value"] > 0


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "nmnist_mlp4.batch_nostats", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_train_cell(root):
    res, _ = run(root, "tiny_mlp.train")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert res["attempted"] % 8 == 0 and res["attempted"] > 0


def unchanged_state(step):
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def half_the_batch(loss):
    def broken(params, spikes, labels, cfg):
        b = spikes.shape[1] // 2
        return loss(params, spikes[:, :b], labels[:b], cfg)
    return broken


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_batch"])
def test_train_faults_fail_correct(root, monkeypatch, fault):
    """A step that returns its state unchanged, and a loss over half the
    batch, each turn ``correct`` false."""
    from repro_torch.engine import snn_train
    if fault == "unchanged_state":
        real = snn_train.make_snn_train_step
        monkeypatch.setattr(snn_train, "make_snn_train_step",
                            lambda *a, **k: unchanged_state(real(*a, **k)))
    else:
        model = snn_train.MLP_MODEL
        monkeypatch.setattr(model, "loss", half_the_batch(model.loss))
    res, _ = run(root, "tiny_mlp.train")
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] > 0
