"""The port's twins of the three SNN examples (``examples/torch_{quickstart,
train_snn,spikify_ffn}.py``) on the CPU, at a few steps: each runs through
``runpy`` with ``--device cpu`` (its own assertions hold: the twin
bit-exact against the dense reference and the batched engine against the
twin; the spikified FFN's error falling with T), and the line it prints
last is checked."""

import os
import re
import runpy
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, argv, monkeypatch, capsys) -> list[str]:
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(REPO, "examples", script),
                   run_name="__main__")
    return capsys.readouterr().out.strip().splitlines()


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    lines = _run("torch_quickstart.py", ["--device", "cpu", "--steps", "4"],
                 monkeypatch, capsys)
    assert any("bit-exact vs dense reference" in l for l in lines)
    assert any(l.startswith("batched engine on cpu: 8 samples") for l in lines)
    assert re.fullmatch(r"served 12 requests of \[.*\] steps in \d+ new "
                        r"shape\(s\) \(<= 4 buckets\), all bit-exact",
                        lines[-1])


def test_spikify_ffn_runs_on_the_cpu(monkeypatch, capsys):
    lines = _run("torch_spikify_ffn.py", ["--device", "cpu"], monkeypatch,
                 capsys)
    errs = [float(re.search(r"rel err\s+([0-9.]+)", l).group(1))
            for l in lines if l.startswith("T=")]
    assert len(errs) == 3 and errs[0] > errs[1] > errs[2]
    assert lines[-1].startswith("   the paper's event-driven energy story")


def test_train_snn_runs_and_resumes_on_the_cpu(monkeypatch, capsys,
                                               tmp_path):
    """One step with a checkpoint, then a second launch on a spoofed
    2-way mesh that resumes from it and trains one more step."""
    ckpt = str(tmp_path / "ck")
    first = _run("torch_train_snn.py", ["--device", "cpu", "--steps", "1",
                                        "--ckpt", ckpt], monkeypatch, capsys)
    assert any(l.startswith("mlp train: loss=") for l in first)
    second = _run("torch_train_snn.py", ["--device", "cpu", "--steps", "2",
                                         "--ckpt", ckpt, "--spoof-devices",
                                         "2"], monkeypatch, capsys)
    assert "mlp: data-parallel over 2 device(s) (spoofed)" in second
    assert any("resumed" in l and "from step 1" in l for l in second)
    assert re.fullmatch(r"Accel_1 execution: [0-9.]+ TOPS/W \(paper Table "
                        r"II: 3\.4\)", second[-1])


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_train_snn.py",
                                    "torch_spikify_ffn.py"])
def test_examples_need_a_card_unless_cpu_is_asked(script, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(os.path.join(REPO, "examples", script),
                       run_name="__main__")
