"""The engine's input bytes a call as the benchmark reads them: silence on
a program without the upload counter, ``b_pad * t_pad * n_in`` a call on a
CPU ``run_bucketed`` (one byte a mask entry), and the reading in the
traced tiny cells."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.helpers import tiny_checkout

SEED = 2**31 + 17
NAMES = {"tiny_mlp.batch_nostats": "engine.upload_bytes",
         "tiny_mlp.stream": "engine.upload_bytes.stream"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("name", sorted(NAMES.values()))
def test_a_program_without_the_counter_reads_none(root, monkeypatch, name):
    from repro_torch.engine import batched_run
    monkeypatch.delattr(batched_run, "upload_counts")
    assert harness.reader(name, root)(None) is None


@pytest.mark.parametrize("name", sorted(NAMES.values()))
def test_no_upload_reads_none(root, monkeypatch, name):
    from repro_torch.engine import batched_run
    monkeypatch.setattr(batched_run, "upload_counts",
                        {"bytes": 0, "uploads": 0})
    assert harness.reader(name, root)(None) is None


def test_cpu_run_bucketed_reads_the_padded_mask(root, monkeypatch):
    """Every engine call puts its bucket's ``[b_pad, t_pad, n_in]`` uint8
    mask on the device: the reading is their mean."""
    from repro_torch.core.accelerator import map_model
    from repro_torch.core.energy import AcceleratorSpec
    from repro_torch.engine import BucketPolicy, batched_run, run_bucketed

    monkeypatch.setattr(batched_run, "upload_counts",
                        {"bytes": 0, "uploads": 0})
    rng = np.random.default_rng(3)
    ws = [rng.normal(0, 0.5, (24, 12)).astype(np.float32),
          rng.normal(0, 0.5, (12, 6)).astype(np.float32)]
    model = map_model(ws, AcceleratorSpec("t", n_cores=2, n_engines=4,
                                          n_caps=8, weight_mem_bytes=1 << 20))
    packed = model.pack(device="cpu")
    streams = [(rng.random((t, 24)) < 0.3).astype(np.float32)
               for t in (3, 9, 5, 16, 2, 7, 12)]
    tel = []
    run_bucketed(packed, streams, with_stats=False, telemetry=tel,
                 policy=BucketPolicy(batch_sizes=(1, 4), time_steps=(4, 16)))
    assert batched_run.upload_counts["uploads"] == len(tel) == 3
    want = [r["b_pad"] * r["t_pad"] * 24 for r in tel]
    assert batched_run.upload_counts["bytes"] == sum(want)
    for name in NAMES.values():
        assert harness.reader(name, root)(None) == sum(want) / len(want)


@pytest.mark.parametrize("workload", sorted(NAMES))
def test_traced_tiny_cells_read_the_counter(root, workload):
    res = harness.run(workload, SEED, 1.0, True, device="cpu", root=root)[0]
    assert res["correct"]
    got = res["metrics"][NAMES[workload]]
    assert got["unit"] == "B" and got["value"] > 0
