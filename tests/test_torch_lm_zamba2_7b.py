"""Zamba2-7B-Instruct on the port's LM path (``get_config("zamba2_7b")``,
the published layout of ``models/zamba2.py``), held at its ``SMOKE`` size
on seeded random weights to the plain reference ``zamba2_reference.py``,
and the reference held to ``transformers``' ``Zamba2ForCausalLM`` on the
same weights.

Limits: ``TIGHT`` where both sides compute in float32 (they differ in
summation order only: the chunked scan against the sequential recurrence,
online against plain softmax; the readings are ~3e-6); the bf16 program
against the reference by the benchmark cell's own ``block_gap`` and
``logit_gap`` limits (``perfbench/workloads/zamba2_7b.chat.json``; their
reasons are in ``PERF.md``), block by block on the program's recorded
inputs, as the cell's check holds them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import zamba2_reference as R

from repro_torch import configs
from repro_torch.configs.common import ArchConfig
from repro_torch.configs.zamba2_7b import Zamba2Config
from repro_torch.core.pytree import tree_map
from repro_torch.launch import serve as S
from repro_torch.models import build_model
from repro_torch.models import zamba2 as Z

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "perfbench/workloads/zamba2_7b.chat.json")
                    .read_text())["traffic"]["limits"]
TIGHT = 1e-4
CFG = configs.get_smoke_config("zamba2_7b")
PROMPT, GEN = 13, 9


def ref_config(c: Zamba2Config) -> dict:
    """``c`` under the published config's keys, as the reference reads it."""
    return {"hidden_size": c.d_model, "mamba_expand": c.ssm_expand,
            "n_mamba_heads": c.ssm_expand * c.d_model // c.ssm_head_dim,
            "mamba_headdim": c.ssm_head_dim, "mamba_ngroups": c.ssm_ngroups,
            "mamba_d_state": c.ssm_state, "mamba_d_conv": c.ssm_conv_width,
            "rms_norm_eps": c.norm_eps, "num_attention_heads": c.n_heads,
            "attention_head_dim": c.resolved_head_dim(),
            "use_mem_rope": True, "rope_theta": c.rope_theta,
            "hybrid_layer_ids": list(c.hybrid_layer_ids),
            "num_mem_blocks": c.n_mem_blocks, "num_hidden_layers": c.n_layers}


RC = ref_config(CFG)
BUNDLE = build_model(CFG)


@pytest.fixture(scope="module")
def params():
    return BUNDLE.init(seed=0, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, CFG.vocab_size, (3, PROMPT + GEN), generator=gen)


@pytest.fixture(scope="module")
def ref_logits(params, tokens):
    return R.forward(tokens, params, RC)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst ``|got - want| / |want|`` over the leading positions."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


class Blocks:
    """A block listener keeping every block's inputs and output, positions
    concatenated."""

    def __init__(self):
        self.got: dict = {}

    def __call__(self, kind, index, inputs, output):
        parts = [t[:, None] if output.dim() == 2 else t
                 for t in (*inputs, output)]
        self.got.setdefault((kind, index), []).append(parts)

    def __enter__(self):
        Z.add_block_listener(self)
        return self

    def __exit__(self, *exc):
        Z.remove_block_listener(self)

    def series(self, kind, index):
        return [torch.cat(p, dim=1) for p in zip(*self.got[(kind, index)])]

    def gaps(self, params, operand=None) -> tuple[float, float]:
        """``block_gap`` and ``logit_gap`` against the reference on the
        recorded inputs (of ``operand``'s reference in the program's place,
        for the control)."""
        def held(f, got, *args):
            want = f(*args, RC)
            return rel(got if operand is None else f(*args, RC, operand),
                       want)

        block = 0.0
        for i in range(CFG.n_layers):
            h, out = self.series("mamba", i)
            block = max(block, held(R.mixer, out, h,
                                    R.layer(params["mamba"], i)))
        for k in range(CFG.n_apps):
            x, e, t = self.series("shared", k)
            sp = R.layer(params["shared"], CFG.block_of(k))
            block = max(block, held(R.shared, t, x, e, sp,
                                    R.layer(params["apps"], k)))
        x, logits = self.series("head", 0)
        return block, held(R.head, logits, x, params)


def test_config_holds_the_published_numbers():
    c = configs.get_config("zamba2_7b")
    assert isinstance(c, Zamba2Config) and c.family == "hybrid"
    assert (c.n_layers, c.d_model, c.ssm_expand, c.ssm_head_dim,
            c.ssm_expand * c.d_model // c.ssm_head_dim, c.ssm_state,
            c.ssm_ngroups, c.ssm_conv_width, c.ssm_chunk) == \
        (81, 3584, 2, 64, 112, 64, 2, 4, 256)
    assert c.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                  65, 71, 77)
    assert (c.n_mem_blocks, c.n_heads, c.n_kv_heads, c.resolved_head_dim(),
            c.attn_in, c.d_ff, c.adapter_rank, c.vocab_size, c.rope_theta,
            c.norm_eps) == (2, 32, 32, 224, 7168, 14336, 128, 32000,
                            10000.0, 1e-5)
    # the registry's schema and ids stay the JAX package's
    assert "zamba2_7b" not in configs.ARCH_IDS
    assert not {"hybrid_layer_ids", "ssm_ngroups"} & {
        f.name for f in dataclasses.fields(ArchConfig)}
    # the smoke variant: block 0 twice with different adapters, uneven gaps
    s = CFG
    assert (s.n_layers, s.hybrid_layer_ids, s.d_model, s.ssm_ngroups,
            s.n_heads, s.adapter_rank, s.vocab_size, s.ssm_chunk) == \
        (9, (2, 5, 7), 64, 2, 4, 8, 256, 8)
    assert BUNDLE.abstract_params()["apps"]["linear"].shape == (3, 64, 64)


def test_full_forward_matches_the_reference(params, tokens, ref_logits):
    assert rel(Z.hybrid_logits(params, CFG, tokens), ref_logits) < TIGHT


def test_prefill_then_decode_is_the_full_forward(params, tokens, ref_logits):
    """Prefill the prompt, then decode the rest of ``tokens`` through the
    cache (the true conv tails, every application's KV slice), each
    step's logits against the reference's full forward."""
    logits, cache = BUNDLE.prefill(params, {"tokens": tokens[:, :PROMPT]})
    for name in ("attn_k", "attn_v"):
        cache[name] = F.pad(cache[name], (0, 0, 0, GEN))
    got = [logits]
    for i in range(PROMPT, PROMPT + GEN - 1):
        logits, cache = BUNDLE.decode(params, cache,
                                      {"tokens": tokens[:, i], "pos": i})
        got.append(logits)
    assert rel(torch.stack(got, 1), ref_logits[:, PROMPT - 1:-1]) < TIGHT


def test_served_in_bf16_within_the_block_limits(params, tokens):
    """``serve`` on the bf16 weights, as the launcher serves every LM: each
    block and each step's logits within the cell's limits."""
    p16 = tree_map(lambda a: a.to(torch.bfloat16), params)
    with Blocks() as rec:
        out = S.serve(BUNDLE, p16, tokens[:, :PROMPT], GEN)
    assert out["tokens"].shape == (3, GEN)
    block, logit = rec.gaps(p16)
    assert block < LIMITS["block_gap"] and logit < LIMITS["logit_gap"]


def _second_group_dropped(p):
    """Heads of group 1 read group 0's B and C: the columns of B and C
    (after ``z`` and x in ``w_in``, after x in the conv) of group 1 made
    group 0's."""
    d_in, n = CFG.ssm_expand * CFG.d_model, CFG.ssm_state
    m = p["mamba"]
    for w, at_b in ((m["w_in"], 2 * d_in), (m["conv_w"], d_in),
                    (m["conv_b"], d_in)):
        for at in (at_b, at_b + 2 * n):             # B, then C
            w[..., at + n:at + 2 * n] = w[..., at:at + n]


OMISSIONS = {
    "lora": lambda p, mp: mp.setattr(Z, "_lora", lambda m, ap: 0),
    "linear": lambda p, mp: p["apps"]["linear"].copy_(
        torch.eye(CFG.d_model)),
    "concat_e": lambda p, mp: mp.setattr(
        Z, "_concat", lambda x, e: torch.cat([x, torch.zeros_like(e)], -1)),
    "conv_bias": lambda p, mp: p["mamba"]["conv_b"].zero_(),
    "second_group": lambda p, mp: _second_group_dropped(p),
    "d_skip": lambda p, mp: p["mamba"]["d_skip"].zero_(),
    "half_head_scale": lambda p, mp: mp.setattr(
        Z, "_attn_scale", lambda c: c.resolved_head_dim() ** -0.5),
}


@pytest.mark.parametrize("omit", list(OMISSIONS))
def test_each_omission_fails(params, tokens, omit, monkeypatch):
    """The program without one piece of the published model, in float32,
    against the reference with it: a block falls outside the block limit."""
    broken = tree_map(lambda a: a.clone(), params)
    OMISSIONS[omit](broken, monkeypatch)
    with Blocks() as rec:
        Z.hybrid_logits(broken, CFG, tokens)
    assert rec.gaps(params)[0] > LIMITS["block_gap"]


def test_the_float8_control_fails(params, tokens):
    """The reference with every operand rounded to float8 e4m3, one
    precision below bf16, in the bf16 program's place, fails a limit."""
    p16 = tree_map(lambda a: a.to(torch.bfloat16), params)
    with Blocks() as rec:
        S.serve(BUNDLE, p16, tokens[:, :PROMPT], GEN)
    block, logit = rec.gaps(p16, R.float8_e4m3)
    assert block > LIMITS["block_gap"] or logit > LIMITS["logit_gap"]


def test_launcher_serves_it(capsys):
    out = S.main(["--arch", "zamba2_7b", "--smoke", "--device", "cpu",
                  "--requests", "2", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert capsys.readouterr().out.startswith("prefill: ")


def _hf_model(params, chunk: int):
    """``transformers``' Zamba2ForCausalLM at the smoke size, holding
    ``params``.  Two departures of its plain-torch mixer from the published
    model are kept out of the comparison: it clamps ``dt`` at
    ``time_step_min``, which the published ``time_step_limit`` of null
    leaves out (the test sets that minimum below every ``dt`` the weights
    give), and its sum over earlier chunks' states runs over the wrong
    chunk index (``.sum(dim=2)`` of ``decay_chunk * states``), so a
    sequence is compared within one chunk of ``chunk`` positions (the
    chunk is no part of the model's mathematics)."""
    for backend in ("USE_TF", "USE_FLAX"):      # torch alone: no JAX loaded
        os.environ.setdefault(backend, "0")
    tf = pytest.importorskip("transformers")
    c = CFG
    types = ["hybrid" if i in c.hybrid_layer_ids else "mamba"
             for i in range(c.n_layers)]
    hc = tf.Zamba2Config(
        vocab_size=c.vocab_size, hidden_size=c.d_model,
        num_hidden_layers=c.n_layers, layers_block_type=types,
        mamba_d_state=c.ssm_state, mamba_d_conv=c.ssm_conv_width,
        mamba_expand=c.ssm_expand, mamba_ngroups=c.ssm_ngroups,
        n_mamba_heads=RC["n_mamba_heads"], chunk_size=chunk,
        intermediate_size=c.d_ff, hidden_act="gelu",
        num_attention_heads=c.n_heads, num_mem_blocks=c.n_mem_blocks,
        adapter_rank=c.adapter_rank, use_mem_rope=True,
        rope_theta=c.rope_theta, rms_norm_eps=c.norm_eps,
        use_mem_eff_path=False, time_step_min=1e-12,
        tie_word_embeddings=True, attn_implementation="eager")
    model = tf.Zamba2ForCausalLM(hc).eval()
    m, sh, ap = params["mamba"], params["shared"], params["apps"]
    sd = {"model.embed_tokens.weight": params["embed"],
          "lm_head.weight": params["embed"],
          "model.final_layernorm.weight": params["ln_f"]}
    for i in range(c.n_layers):
        pre = f"model.layers.{i}."
        if i in c.hybrid_layer_ids:
            k = c.hybrid_layer_ids.index(i)
            b = c.block_of(k)
            sd[pre + "linear.weight"] = ap["linear"][k].T
            st = pre + "shared_transformer."
            sd[st + "input_layernorm.weight"] = sh["ln1"][b]
            sd[st + "pre_ff_layernorm.weight"] = sh["ln2"][b]
            for w, name in (("wq", "q_proj"), ("wk", "k_proj"),
                            ("wv", "v_proj"), ("wo", "o_proj")):
                sd[st + f"self_attn.{name}.weight"] = sh[w][b].T
            sd[st + "feed_forward.gate_up_proj.weight"] = sh["w_gu"][b].T
            sd[st + "feed_forward.down_proj.weight"] = sh["w_down"][b].T
            ad = st + f"feed_forward.gate_up_proj_adapter_list.{k}."
            sd[ad + "0.weight"] = ap["lora_a"][k].T
            sd[ad + "1.weight"] = ap["lora_b"][k].T
            pre += "mamba_decoder."
        sd[pre + "input_layernorm.weight"] = m["ln"][i]
        mx = pre + "mamba."
        sd[mx + "in_proj.weight"] = m["w_in"][i].T
        sd[mx + "conv1d.weight"] = m["conv_w"][i].T[:, None, :]
        sd[mx + "conv1d.bias"] = m["conv_b"][i]
        sd[mx + "dt_bias"] = m["dt_bias"][i]
        sd[mx + "A_log"] = m["a_log"][i]
        sd[mx + "D"] = m["d_skip"][i]
        sd[mx + "norm.weight"] = m["ln_y"][i]
        sd[mx + "out_proj.weight"] = m["w_out"][i].T
    own = model.state_dict()
    for key, val in sd.items():
        assert own[key].shape == val.shape, key
        own[key].copy_(val)
    return model


def test_reference_is_transformers_zamba2(params, tokens, ref_logits):
    """The reference and ``transformers``' Zamba2ForCausalLM (plain-torch
    path, eager attention) on the same weights: what ties the reference to
    the published description."""
    model = _hf_model(params, chunk=tokens.shape[1])
    with torch.no_grad():
        got = model(tokens, use_cache=False).logits
    assert rel(got, ref_logits) < TIGHT
