"""The program's stage spans as the benchmark reads them: the trace's
summary of a run with the harness's spans alone, the new readers in the
traced tiny cells, and their silence on a program without stage
spans."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.helpers import tiny_checkout
from perfbench.trace import Summary

SEED = 2**31 + 7

BATCH = ("serving.pad_ms", "engine.upload_ms", "engine.issue_ms",
         "engine.readback_ms")
STREAM = ("server.dispatch_ms",)
TRAIN = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms")


def test_summary_of_the_harness_spans():
    """Device operations, busy time and idle gaps of a trace that holds
    only the harness's spans: an operation past the window is clipped, a
    gap on a span's edge is that span's, a gap in no span the host's."""
    s = Summary(window=(0.0, 10.0),
                ops=[("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0),
                     ("copy", 8.0, 8.5), ("late", 9.75, 11.0)],
                spans=[("window", 0.0, 10.0), ("run_bucketed", 0.5, 4.0),
                       ("run_bucketed", 4.5, 9.0),
                       ("train.step", 6.25, 7.5)])
    assert s.busy() == [(1.0, 3.0), (5.0, 6.0), (8.0, 8.5), (9.75, 10.0)]
    assert s.busy_s == 3.75
    assert s.device_seconds("k1") == 2.0
    assert s.device_ops() == [["k1", 2.0], ["k2", 1.5], ["late", 1.25],
                              ["copy", 0.5]]
    assert s.idle_gaps() == [["run_bucketed", 3.0], ["train.step", 2.0],
                             ["host", 1.25]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def run(root, workload, seconds=1.0):
    return harness.run(workload, SEED, seconds, True, device="cpu",
                       root=root)[0]


@pytest.mark.parametrize("workload,names", [
    ("tiny_mlp.batch_nostats", BATCH), ("tiny_mlp.stream", STREAM),
    ("tiny_mlp.train", TRAIN)])
def test_traced_cells_print_the_stage_metrics(root, workload, names):
    res = run(root, workload, seconds=1.5)
    assert res["correct"]
    for name in names:
        assert res["metrics"][name]["value"] > 0
        assert res["metrics"][name]["unit"] == "ms"
    if workload == "tiny_mlp.batch_nostats":
        # the engine's stages lie inside the call that engine.call_ms times
        inner = sum(res["metrics"][n]["value"] for n in BATCH[1:])
        assert inner <= res["metrics"]["engine.call_ms"]["value"]


def test_a_program_without_stage_spans_reads_none(root, monkeypatch):
    """Against a program that has no stage spans, as before they came,
    the readers find nothing and the line leaves their metrics out."""
    from repro_torch.engine import tracing
    monkeypatch.delattr(tracing, "stage_totals")
    res = run(root, "tiny_mlp.batch_nostats")
    assert res["correct"]
    assert not set(BATCH) & set(res["metrics"])
    assert "engine.call_ms" in res["metrics"]


def test_innermost_at_any_depth():
    """Gaps under a span chain five deep, one in a parent's own time after
    more than four of its children have ended, one between two spans and
    one on a span's edge."""
    from perfbench.stages import innermost
    spans = [(0.0, 100.0, "window"), (10.0, 90.0, "server.submit"),
             (11.0, 80.0, "server.dispatch"), (12.0, 70.0, "serving.execute"),
             (13.0, 20.0, "engine.upload")]
    spans += [(21.0 + 2 * k, 22.0 + 2 * k, "engine.forward")
              for k in range(6)]
    gaps = [(14.0, 15.0), (40.0, 50.0), (75.0, 76.0), (91.0, 95.0),
            (100.0, 100.0)]
    chains = innermost(spans, gaps)
    assert chains[0] == ["window", "server.submit", "server.dispatch",
                         "serving.execute", "engine.upload"]
    assert chains[1] == ["window", "server.submit", "server.dispatch",
                         "serving.execute"]
    assert chains[2] == ["window", "server.submit", "server.dispatch"]
    assert chains[3] == ["window"]
    assert chains[4] == ["window"]


def test_stages_tool_names_gaps_by_program_spans(root, monkeypatch, capsys):
    import json

    from perfbench import stages
    for key in ("REPRO_TORCH_BUILD", "TRITON_CACHE_DIR",
                "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(key, "unset")
    monkeypatch.setattr(stages, "ROOT", root)
    assert stages.main(["--workload", "tiny_mlp.batch_nostats", "--seed",
                        str(SEED), "--seconds", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["correct"] and "requests_per_s" in line["metrics"]
    found = line["stages"]
    assert found["on_card"] == {}
    assert found["span_ms"]["serving.execute"][1] >= 1
    # on the CPU nothing runs on the card: the window is one idle gap
    assert sum(v for _, v in found["idle_gaps"]) == \
        pytest.approx(line["device"]["window_s"])
    # the tool hands the harness back as it found it
    from perfbench import trace
    assert trace.summarize.__name__ == "summarize"
    assert harness.metrics_for.__name__ == "metrics_for"
