"""The grouped SSD scan's dispatch, its plain version and its launcher's
refusals, on the CPU (``kernels/ssd_scan.py``; the kernel itself is held
to the plain version on the card, ``tests/test_torch_cuda.py``).

The dispatch is observed on CPU tensors that report themselves on a card
(``_OnCard``), with the launcher replaced: the rule is what decides, not
the kernel.  The plain version is held to the step-by-step grouped
recurrence at ``TOL``: both in float32, differing in summation order only
(chunked products against one step at a time; the readings are ~1e-6).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch import stage_spans
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels.ssd_scan import scan_inputs, ssd_scan_stepwise
from repro_torch.models import mamba2 as M
from repro_torch.stage_spans import stage_totals

TOL = 1e-5


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a card."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t, t.requires_grad)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("l,chunk,g", [
    (40, 8, 2),      # whole chunks
    (37, 8, 2),      # the last chunk padded
    (5, 8, 1),       # shorter than one chunk
    (1, 8, 2),       # one step
    (70, 256, 1),    # the config's chunk, one padded chunk
])
def test_plain_scan_equals_the_stepwise_recurrence(l, chunk, g):
    ins = scan_inputs(2, l, 4, 8, 12, g, seed=l)
    y, state = K.ssd_scan_plain(*ins, chunk)
    want_y, want_s = ssd_scan_stepwise(*ins)
    assert y.shape == (2, l, 4, 8) and state.shape == (2, 4, 8, 12)
    assert gap(y, want_y) < TOL and gap(state, want_s) < TOL


def test_cpu_call_takes_the_plain_path(monkeypatch):
    """On the CPU the dispatch runs the plain version: the launcher is not
    reached and the launch count stays 0, with or without grad."""
    monkeypatch.setattr(K, "ssd_scan_cuda", lambda *a: pytest.fail(
        "the CPU path reached the launcher"))
    _build.reset_launches()
    ins = scan_inputs(2, 13, 4, 8, 8, 2)
    want = K.ssd_scan_plain(*ins, 8)
    with torch.no_grad():
        got = K.ssd_scan(*ins, 8)
    for gi, wi in zip(got, want):
        assert torch.equal(gi, wi)
    assert _build.launches["ssd_scan"] == 0


def test_call_under_autograd_takes_the_plain_path(monkeypatch):
    """Inputs on a card that record a gradient take the plain version
    (the kernel has no backward); the gradient reaches them."""
    monkeypatch.setattr(K, "ssd_scan_cuda", lambda *a: pytest.fail(
        "a call under autograd reached the launcher"))
    _build.reset_launches()
    x, dt, a, b, c, d = scan_inputs(2, 13, 4, 8, 8, 2)
    a = a.clone().requires_grad_()
    y, state = K.ssd_scan(_on_card(x), dt, a, b, c, d, 8)
    (y.sum() + state.sum()).backward()
    assert a.grad is not None and torch.isfinite(a.grad).all()
    assert _build.launches["ssd_scan"] == 0


def test_card_call_without_grad_takes_the_kernel_inside_its_span(
        monkeypatch):
    """Inputs on a card with no gradient recorded go to the launcher, once,
    inside the stage span ``lm.ssd_scan``; the same call with grad on but
    nothing requiring it does too.  The span's totals go to a fresh table,
    so the process's own, which the benchmark's readers read, keeps no
    span of this test."""
    monkeypatch.setattr(stage_spans, "_totals", {})
    calls = []

    def launcher(*args):
        calls.append(len(args))
        return K.ssd_scan_plain(*args, 8)

    monkeypatch.setattr(K, "ssd_scan_cuda", launcher)
    x, *rest = scan_inputs(2, 13, 4, 8, 8, 2)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            K.ssd_scan(_on_card(x), *rest, 8)
    K.ssd_scan(_on_card(x), *rest, 8)
    assert calls == [6, 6]
    assert stage_totals()["lm.ssd_scan"][1] == 1


def test_mixer_block_on_the_cpu_launches_nothing():
    """The published mixer (Zamba2-7B at its smoke size) on the CPU runs
    the plain scan and launches nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("zamba2_7b")
    params = build_model(cfg).init(seed=0, dtype=torch.float32, device="cpu")
    lp = {k: v[0] for k, v in M.mixer_f32_leaves(params["mamba"]).items()}
    h_in = torch.randn(2, 11, cfg.d_model,
                       generator=torch.Generator().manual_seed(0))
    _build.reset_launches()
    with torch.no_grad():
        out, state, tail = M.mixer_block(h_in, lp, cfg)
    assert _build.launches["ssd_scan"] == 0
    assert out.shape == h_in.shape and torch.isfinite(out).all()
    assert state.shape == (2, cfg.ssm_expand * cfg.d_model
                           // cfg.ssm_head_dim, cfg.ssm_head_dim,
                           cfg.ssm_state)


@pytest.mark.parametrize("on_card,grad,counted", [
    (False, False, 0), (False, True, 0), (True, True, 1), (True, False, 0)])
def test_plain_scans_on_a_card_are_counted(monkeypatch, on_card, grad,
                                           counted):
    """``plain_on_card`` counts each plain scan that runs on a card (here
    one under autograd); CPU calls, with a gradient or without, and kernel
    launches count nothing."""
    monkeypatch.setattr(K, "ssd_scan_cuda",
                        lambda x, *rest: (torch.zeros_like(x), None))
    x, dt, a, b, c, d = scan_inputs(2, 13, 4, 8, 8, 2)
    a = a.clone().requires_grad_(grad)
    before = K.plain_on_card
    K.ssd_scan(_on_card(x) if on_card else x, dt, a, b, c, d, 8)
    assert K.plain_on_card == before + counted


def test_mamba2_block_scans_one_group_through_the_grouped_scan(monkeypatch):
    """The older layouts' block (Mamba2-2.7B at its smoke size) hands the
    grouped plain scan its B and C as one group, D skip included: with the
    step-by-step recurrence in the scan's place its output and state
    agree."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("mamba2_2_7b")
    params = build_model(cfg).init(seed=0, dtype=torch.float32, device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn(2, 11, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    groups, plain = [], K.ssd_scan_plain

    def spy(*args):
        groups.append(args[3].shape[2])
        return plain(*args)

    monkeypatch.setattr(K, "ssd_scan_plain", spy)
    with torch.no_grad():
        got, state = M.mamba2_block(x, lp, cfg)
    monkeypatch.setattr(K, "ssd_scan_plain",
                        lambda *args: ssd_scan_stepwise(*args[:6]))
    with torch.no_grad():
        want, want_state = M.mamba2_block(x, lp, cfg)
    assert groups == [1]
    assert gap(got, want) < TOL and gap(state, want_state) < TOL


def _refusal_cases():
    """(name, build) pairs: each build returns scan arguments that the
    launcher refuses (on the CPU, as it would on a card: its checks run
    before any launch)."""
    def base():
        return list(scan_inputs(2, 13, 4, 8, 8, 2))

    def at(i, f):
        def build():
            args = base()
            args[i] = f(args[i])
            return args
        return build

    def zeros(*shape):
        return torch.zeros(shape)

    return {
        "x_float64": at(0, lambda t: t.double()),
        "x_bf16": at(0, lambda t: t.to(torch.bfloat16)),
        "b_short": at(3, lambda t: t[:, :12]),
        "c_rank3": at(4, lambda t: t[:, :, 0]),
        "x_heads_not_packed": at(0, lambda t: zeros(2, 13, 4, 12)[..., :8]),
        "x_last_dim_strided": at(0, lambda t: zeros(2, 13, 4, 16)[..., ::2]),
        "x_misaligned_rows": at(0, lambda t: zeros(t.numel() + 1)[1:].view(
            t.shape)),
        "dt_wrong_shape": at(1, lambda t: t[:, :, :3]),
        "dt_float64": at(1, lambda t: t.double()),
        "a_wrong_shape": at(2, lambda t: t[:3]),
        "d_strided": at(5, lambda t: torch.stack([t, t], 1)[:, 0]),
        "p_above_64": lambda: list(scan_inputs(1, 3, 2, 68, 8, 1)),
        "n_above_64": lambda: list(scan_inputs(1, 3, 2, 8, 68, 1)),
        "p_not_multiple_of_4": lambda: list(scan_inputs(1, 3, 2, 6, 8, 1)),
        "heads_not_multiple_of_groups": lambda: list(
            scan_inputs(1, 3, 3, 8, 8, 2)),
        "on_the_cpu": base,
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_launcher_refuses_what_the_kernel_cannot_take(case):
    _build.reset_launches()
    args = _refusal_cases()[case]()
    with pytest.raises(ValueError):
        K.ssd_scan_cuda(*args)
    assert _build.launches["ssd_scan"] == 0
