"""The LM serving cell on the CPU at the Zamba2 smoke size: a temporary
checkout of the benchmark with a tiny configuration and cell added as
files, run through the harness; ``correct`` true, the cell's metrics
found, and ``correct`` false under a fault planted in the program's timed
path.  And the benchmark's copy of the reference gives the tests' own
reference's outputs, and the cell's counts are the program's weights."""

from __future__ import annotations

import importlib.util
import json
import shutil

import pytest
import torch

from perfbench import harness
from perfbench.drivers import lm_serve
from perfbench.reference import zamba2 as bench_ref
from perfbench.tests.helpers import REPO

SEED = 2**31 + 77
CELL = "zamba2_tiny.chat"
LM_METRICS = ("lm.prefill_ms", "lm.decode_step_ms", "lm.mamba_ms",
              "lm.shared_block_ms")


def tiny_config() -> dict:
    """The program's smoke variant under the published config's keys."""
    from repro_torch.configs import get_smoke_config
    mc = get_smoke_config("zamba2_7b")
    cfg = {"name": "zamba2_tiny", "arch": "zamba2_7b", "smoke": True,
           "reference": "zamba2"}
    cfg.update({k: f(mc) for k, f in lm_serve.PUBLISHED.items()})
    cfg.update(lm_serve.FIXED)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "perfbench/configs/zamba2_tiny.json").write_text(
        json.dumps(tiny_config()))
    real = json.loads((REPO / "perfbench/workloads/zamba2_7b.chat.json")
                      .read_text())
    real["config"] = "zamba2_tiny"
    real["traffic"].update(requests_per_call=3, prompt_len=12, gen=5,
                           pool_calls=2)
    (tmp / f"perfbench/workloads/{CELL}.json").write_text(json.dumps(real))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zamba2_tiny", "source": "tests",
                            "file": "perfbench/configs/zamba2_tiny.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "zamba2_tiny",
                              "traffic": "chat", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "zamba2_7b.chat" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(root, trace=False):
    return harness.run(CELL, SEED, 0.5, trace, device="cpu", root=root)


def test_the_cell_is_correct_and_reports_its_metrics(root):
    res, err = run(root)
    assert res["correct"], err
    assert res["failed"] == 0 and res["attempted"] % 3 == 0
    assert set(res["metrics"]) == {"requests_per_s", "setup_s"}
    assert set(res["checks"]) == {"replay_tokens", "block_gap", "logit_gap"}
    res, err = run(root, trace=True)
    assert res["correct"], err
    assert set(LM_METRICS) <= set(res["metrics"])
    # the card's shares are read on the card alone
    assert not {"lm.decode_bw_share", "lm_serve_mfu", "device_idle.lm"} \
        & set(res["metrics"])


def _flip_top_logit(orig):
    def head(x, params, cfg):
        out = orig(x, params, cfg).clone()
        top = out.argmax(-1, keepdim=True)
        return out.scatter(-1, top, -out.gather(-1, top))
    return head


@pytest.mark.parametrize("fault", ["flipped_logit", "dropped_adapter"])
def test_a_planted_fault_is_not_correct(root, fault, monkeypatch):
    from repro_torch.models import zamba2
    if fault == "flipped_logit":
        monkeypatch.setattr(zamba2, "_head", _flip_top_logit(zamba2._head))
    else:
        monkeypatch.setattr(zamba2, "_lora", lambda m, ap: 0)
    res, err = run(root)
    assert not res["correct"], err


def test_the_benchmark_copy_is_the_tests_reference():
    spec = importlib.util.spec_from_file_location(
        "tests_zamba2_reference", REPO / "tests/zamba2_reference.py")
    tests_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_ref)
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = tiny_config()
    params = build_model(get_smoke_config("zamba2_7b")).init(
        seed=3, device="cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 11),
                           generator=torch.Generator().manual_seed(4))
    want = tests_ref.forward(tokens, params, cfg)
    assert torch.equal(bench_ref.forward(tokens, params, cfg), want)
    x = torch.randn(2, 5, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(bench_ref.float8_e4m3(x), tests_ref.float8_e4m3(x))


def test_counts_are_the_programs_weights():
    """``lm_counts`` at the published config against the program's own
    parameters: the matrices a token multiplies (a mixer's, an
    application's with its shared block, the tied head's) and the bytes a
    decode step reads (every weight, each shared block once per
    application); and the issue's floors of the cell's shape."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models import build_model
    from perfbench import lm_counts
    cfg = json.loads((REPO / "perfbench/configs/zamba2_7b.json").read_text())
    mc = get_config("zamba2_7b")
    ab = build_model(mc).abstract_params()
    m, sh, ap = ab["mamba"], ab["shared"], ab["apps"]
    w = lm_counts.matmul_weights(cfg)
    assert w["mixer"] == m["w_in"][0].numel() + m["w_out"][0].numel()
    assert w["app"] == sum(sh[k][0].numel() for k in (
        "wq", "wk", "wv", "wo", "w_gu", "w_down")) + sum(
        ap[k][0].numel() for k in ap)
    assert w["head"] == ab["embed"].numel()
    total = sum(t.numel() for t in tree_leaves(ab))
    block = sum(sh[k][0].numel() for k in sh)
    assert lm_counts.weight_bytes(cfg) == 2 * (
        total + (mc.n_apps - mc.n_mem_blocks) * block)
    step = lm_counts.decode_step_bytes(cfg, 16, 2048, 128)
    assert 39.4e9 < step < 39.6e9
    assert 780e12 < lm_counts.call_flops(cfg, 16, 2048, 128) < 781e12
