"""The engine's graph-replay share as the benchmark reads it: the reader's
arithmetic on the program's stage totals, its reading in the traced tiny
cells (the CPU path captures no graph), and its silence on a program
without the ``engine.replay`` span."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.helpers import tiny_checkout

SEED = 2**31 + 11
NAMES = {"tiny_mlp.batch_nostats": "engine.graph_replay_share",
         "tiny_mlp.stream": "engine.graph_replay_share.stream"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("name", sorted(NAMES.values()))
@pytest.mark.parametrize("totals,want", [
    ({"engine.forward": (2.0, 8), "engine.replay": (0.5, 6)}, 0.75),
    ({"engine.forward": (2.0, 8)}, 0.0),
    ({"engine.replay": (0.5, 6)}, None),
    ({}, None)])
def test_reader_divides_replays_by_forwards(root, monkeypatch, name, totals,
                                            want):
    from repro_torch.engine import tracing
    monkeypatch.setattr(tracing, "stage_totals", lambda: dict(totals))
    assert harness.reader(name, root)(None) == want


@pytest.mark.parametrize("workload", sorted(NAMES))
def test_cpu_cells_read_no_replay(root, workload):
    res = harness.run(workload, SEED, 1.0, True, device="cpu", root=root)[0]
    assert res["correct"]
    got = res["metrics"][NAMES[workload]]
    assert got["value"] == 0.0 and got["unit"] == "ratio"


def test_a_program_without_the_replay_span_reads_none(root, monkeypatch):
    """Against a program whose stage spans lack ``engine.replay``, as
    before the graph cache, the line leaves the share out."""
    from repro_torch.engine import tracing
    monkeypatch.setattr(tracing, "STAGE_SPANS", tuple(
        s for s in tracing.STAGE_SPANS if s != "engine.replay"))
    res = harness.run("tiny_mlp.batch_nostats", SEED, 1.0, True,
                      device="cpu", root=root)[0]
    assert res["correct"]
    assert "engine.graph_replay_share" not in res["metrics"]
    assert "engine.issue_ms" in res["metrics"]
