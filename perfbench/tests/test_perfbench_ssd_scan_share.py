"""The LM cell's scan-kernel share as the benchmark reads it: the
reader's arithmetic on the program's stage totals, and its silence on a
program without the ``lm.ssd_scan`` span (as before the kernel) or with
no prefill in the window; and the tiny LM cell on the CPU, which runs
the plain scan, reads 0."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.helpers import REPO
from perfbench.tests.test_perfbench_lm_serve import root, run  # noqa: F401

NAME = "lm.ssd_scan_share"
RUN = SimpleNamespace(config={"num_hidden_layers": 81})


@pytest.mark.parametrize("totals,want", [
    ({"lm.prefill": (11.7, 2), "lm.ssd_scan": (0.7, 162)}, 1.0),
    ({"lm.prefill": (11.7, 2), "lm.ssd_scan": (0.35, 81)}, 0.5),
    ({"lm.prefill": (11.7, 2)}, 0.0),
    ({"lm.ssd_scan": (0.7, 162)}, None),
    ({}, None)])
def test_reader_divides_scans_by_prefill_mixers(monkeypatch, totals, want):
    from repro_torch.engine import tracing
    monkeypatch.setattr(tracing, "stage_totals", lambda: dict(totals))
    assert harness.reader(NAME, REPO)(RUN) == want


def test_a_program_without_the_scan_span_reads_none(monkeypatch):
    from repro_torch.engine import tracing
    monkeypatch.setattr(tracing, "STAGE_SPANS", tuple(
        s for s in tracing.STAGE_SPANS if s != "lm.ssd_scan"))
    monkeypatch.setattr(tracing, "stage_totals", lambda: {
        "lm.prefill": (11.7, 2), "lm.ssd_scan": (0.7, 162)})
    assert harness.reader(NAME, REPO)(RUN) is None


def test_the_cell_on_the_cpu_reads_a_share_of_zero(root):
    # the CPU path runs the plain scan: no prefill mixer took the kernel
    res, err = run(root, trace=True)
    assert res["correct"], err
    assert res["metrics"][NAME]["value"] == 0.0
