"""The port's architecture registry and token pipeline against the
reference's: every config field for field, the shape grid, and the
synthetic token batches bit for bit."""

import dataclasses

import numpy as np
import pytest

from repro import configs as rc
from repro.data import tokens as rt

from repro_torch import configs as pc
from repro_torch.data import tokens as pt


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_config_fields_match_reference(arch):
    """``CONFIG`` and ``SMOKE`` of every architecture: the same fields, the
    same values, the same derived properties."""
    for get in ("get_config", "get_smoke_config"):
        ref, port = getattr(rc, get)(arch), getattr(pc, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert port.resolved_head_dim() == ref.resolved_head_dim()
        assert port.is_attention_free == ref.is_attention_free
        assert port.sub_quadratic == ref.sub_quadratic


def test_registry_matches_reference():
    """The same ids in the same order, aliases with dashes, and the whole
    registry from ``all_configs``."""
    assert pc.ARCH_IDS == rc.ARCH_IDS
    assert pc._ALIAS == rc._ALIAS
    assert pc.get_config("internlm2-1-8b") == pc.get_config("internlm2_1_8b")
    got = {k: dataclasses.asdict(v) for k, v in pc.all_configs().items()}
    want = {k: dataclasses.asdict(v) for k, v in rc.all_configs().items()}
    assert got == want


def test_shapes_and_applicability_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in pc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    for arch in rc.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            assert pc.applicable_shapes(getattr(pc, get)(arch)) == \
                rc.applicable_shapes(getattr(rc, get)(arch)), (arch, get)


def test_full_configs_match_assignment():
    """The exact published numbers from the assignment table."""
    c = pc.get_config("deepseek_67b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.d_ff, c.vocab_size) == (95, 8192, 64, 8, 22016, 102400)
    q = pc.get_config("qwen3_moe_235b_a22b")
    assert (q.n_layers, q.n_experts, q.top_k, q.vocab_size) == \
        (94, 128, 8, 151936)
    m = pc.get_config("mixtral_8x7b")
    assert (m.n_experts, m.top_k, m.window) == (8, 2, 4096)
    z = pc.get_config("zamba2_2_7b")
    assert (z.n_layers, z.ssm_state, z.family) == (54, 64, "hybrid")
    mm = pc.get_config("mamba2_2_7b")
    assert (mm.n_layers, mm.ssm_state, mm.d_ff) == (64, 128, 0)
    w = pc.get_config("whisper_medium")
    assert (w.n_layers, w.d_model, w.vocab_size) == (24, 1024, 51865)
    i = pc.get_config("internlm2_1_8b")
    assert (i.n_layers, i.d_model, i.n_heads, i.n_kv_heads, i.head_dim,
            i.d_ff, i.vocab_size, i.rope_theta) == \
        (24, 2048, 16, 8, 128, 8192, 92544, 1e6)


def test_long_500k_applicability():
    """Sub-quadratic archs run long_500k; full-attention archs skip."""
    runs = {a: "long_500k" in pc.applicable_shapes(pc.get_config(a))
            for a in pc.ARCH_IDS}
    assert runs["mamba2_2_7b"] and runs["zamba2_2_7b"]
    assert runs["mixtral_8x7b"] and runs["h2o_danube_1_8b"]  # SWA
    for a in ("internvl2_26b", "qwen3_moe_235b_a22b", "internlm2_20b",
              "internlm2_1_8b", "deepseek_67b", "whisper_medium"):
        assert not runs[a]


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("vocab", [256, 32000, 92544])
def test_token_batch_matches_reference(vocab, seed, step):
    ref = rt.token_batch(rt.TokenPipelineConfig(vocab, 24, 4, seed), step)
    got = pt.token_batch(pt.TokenPipelineConfig(vocab, 24, 4, seed), step)
    assert got["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], ref["tokens"])


def test_token_batches_walk_the_steps():
    """``token_batches`` from a start step yields that step's batch, then
    the next, as the reference's does."""
    cfg = pt.TokenPipelineConfig(vocab_size=1000, seq_len=8, global_batch=2)
    it = pt.token_batches(cfg, start_step=7)
    ref = rt.token_batches(rt.TokenPipelineConfig(1000, 8, 2), start_step=7)
    for step in (7, 8, 9):
        got = next(it)["tokens"]
        assert np.array_equal(got, pt.token_batch(cfg, step)["tokens"])
        assert np.array_equal(got, next(ref)["tokens"])
