"""Zamba2-style hybrid in PyTorch: a Mamba2 backbone plus a *shared*
attention block applied after every ``hybrid_period`` SSM layers
(arXiv:2411.15242).

The shared block's weights are one parameter set, cast to bf16 once per
call and reused at every application; each application keeps its own KV
cache slice ``[n_outer, B, KH, clen, hd]``.  The 54 stacked mamba layers
are grouped as (n_outer, period); the outer loop runs a group's mamba
layers, then the shared attention + FFN block.  Decode writes the states
and the new keys and values into the cache tensors in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.core.pytree import tree_map
from repro_torch.models.layers import (P, bf16_layers, cross_entropy,
                                       flash_attention, init_params,
                                       param_axes, rms_norm, rotary_embed,
                                       swiglu)
from repro_torch.models.mamba2 import (_embed, mamba2_block,
                                       mamba2_block_decode,
                                       mamba2_cache_spec,
                                       mamba2_layer_specs)
from repro_torch.models.transformer import (_cache_positions,
                                            _decode_position,
                                            decode_attention)


def _outer(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.hybrid_period
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers do not group by the "
                         f"hybrid period {period}")
    return cfg.n_layers // period, period


def zamba2_specs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    h, kh = cfg.n_heads, cfg.n_kv_heads
    shared = {
        "ln1": P((d,), ("embed",), "ones"),
        "ln2": P((d,), ("embed",), "ones"),
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
        "w_gate": P((d, cfg.d_ff), ("embed", "mlp")),
        "w_up": P((d, cfg.d_ff), ("embed", "mlp")),
        "w_down": P((cfg.d_ff, d), ("mlp", "embed")),
    }
    return {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "embed", scale=0.02),
        "lm_head": P((d, cfg.vocab_size), ("embed", "vocab")),
        "ln_f": P((d,), ("embed",), "ones"),
        "mamba": mamba2_layer_specs(cfg),
        "shared": shared,
    }


def init_zamba2(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32, device="cuda"):
    return init_params(generator, zamba2_specs(cfg), dtype, device)


def zamba2_axes(cfg: ArchConfig):
    return param_axes(zamba2_specs(cfg))


def _shared_block(x, sp, cfg: ArchConfig, positions, q_chunk=512,
                  kv_chunk=512):
    """The shared attention + FFN block over a full sequence.  Returns the
    new ``x`` and the block's roped keys and unroped values [B, S, KH, hd]
    (what prefill caches)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, sp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, sp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, sp["wv"])
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=cfg.window,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + torch.einsum("bshk,hkd->bsd", o, sp["wo"])
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, sp["w_gate"], sp["w_up"], sp["w_down"]), k, v


def _group_params(params, cfg: ArchConfig) -> list[list[dict]]:
    """The mamba layers' weights in bf16, as ``[group][layer]`` dicts of
    views into the stacked tensors."""
    n_outer, period = _outer(cfg)
    mamba = bf16_layers(params["mamba"])
    return [[{k: v[g * period + j] for k, v in mamba.items()}
             for j in range(period)] for g in range(n_outer)]


def _shared(params) -> dict:
    return tree_map(lambda a: a.to(torch.bfloat16), params["shared"])


def _forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    """The full forward: the final hidden states [B, S, d] (before
    ``ln_f``), each mamba layer's final SSM state, and each shared-block
    application's keys and values."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    shared = _shared(params)
    states, ks, vs = [], [], []
    for group in _group_params(params, cfg):
        for lp in group:
            x, state = mamba2_block(x, lp, cfg)
            states.append(state)
        x, k, v = _shared_block(x, shared, cfg, positions)
        ks.append(k)
        vs.append(v)
    return x, states, ks, vs


def zamba2_logits(params: dict, cfg: ArchConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    x, _, _, _ = _forward(params, cfg, tokens)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(torch.bfloat16)


def zamba2_loss(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    toks = batch["tokens"]
    logits = zamba2_logits(params, cfg, toks[:, :-1])
    return cross_entropy(logits, toks[:, 1:])


def zamba2_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    """Full forward collecting the decode cache: per-layer SSM states, the
    conv tail (zeros, as in :func:`repro_torch.models.api._mamba2_prefill`:
    prefill followed by decode is not the full forward), and the shared
    block's keys (roped) and values per application.  Returns (last-token
    logits, cache)."""
    b, _ = tokens.shape
    x, states, ks, vs = _forward(params, cfg, tokens)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ params["lm_head"].to(torch.bfloat16)
    d_in = cfg.ssm_expand * cfg.d_model
    cache = {
        "ssm": torch.stack(states),
        "conv": torch.zeros((cfg.n_layers, b, cfg.ssm_conv_width - 1, d_in),
                            dtype=torch.bfloat16, device=x.device),
        "attn_k": torch.stack([k.transpose(1, 2) for k in ks]).to(
            torch.bfloat16),
        "attn_v": torch.stack([v.transpose(1, 2) for v in vs]).to(
            torch.bfloat16),
    }
    return logits, cache


# ------------------------------------------------------------------ decode

def zamba2_cache_spec(cfg: ArchConfig, batch: int, cache_len: int):
    n_outer, _ = _outer(cfg)
    hd = cfg.resolved_head_dim()
    spec, axes = mamba2_cache_spec(cfg, batch)
    kv = torch.empty((n_outer, batch, cfg.n_kv_heads, cache_len, hd),
                     dtype=torch.bfloat16, device="meta")
    kv_axes = ("layers", "cache_batch", "cache_kv_heads", "cache_seq",
               "act_head_dim")
    spec.update(attn_k=kv, attn_v=kv)
    axes.update(attn_k=kv_axes, attn_v=kv_axes)
    return spec, axes


def init_zamba2_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    spec, _ = zamba2_cache_spec(cfg, batch, cache_len)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def zamba2_decode_step(params: dict, cfg: ArchConfig, cache: dict,
                       tokens: torch.Tensor, pos,
                       attn_impl=decode_attention):
    """One decode step.  tokens [B] int; ``pos`` a Python int or a 0-d
    integer tensor (:func:`~repro_torch.models.transformer._decode_position`).
    Returns (logits [B, V], cache), the cache written in place."""
    clen = cache["attn_k"].shape[3]
    pos, slot = _decode_position(cfg, pos, cache["attn_k"])
    slot_pos = _cache_positions(cfg, clen, pos)
    x = _embed(params, cfg, tokens)
    sp = _shared(params)
    i = 0
    for g, group in enumerate(_group_params(params, cfg)):
        for lp in group:
            x = mamba2_block_decode(x, lp, cfg, cache["ssm"][i],
                                    cache["conv"][i])
            i += 1
        x = _shared_block_decode(x, sp, cfg, cache["attn_k"][g],
                                 cache["attn_v"][g], pos, slot, slot_pos,
                                 attn_impl)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(torch.bfloat16), cache


def _shared_block_decode(x, sp, cfg: ArchConfig, ck, cv, pos, slot,
                         slot_pos, attn_impl=decode_attention):
    """One token through the shared block.  x [B, d]; ``ck`` / ``cv``
    [B, KH, C, hd] this application's cache, the new key (roped) and value
    written into slot ``slot`` in place; ``pos`` the token's position (0-d
    tensor), ``slot_pos`` [C] each slot's.  Returns the new ``x``."""
    posb = pos.expand(x.shape[0], 1)
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    q = torch.einsum("bd,dhk->bhk", h, sp["wq"])
    k_new = torch.einsum("bd,dhk->bhk", h, sp["wk"])
    v_new = torch.einsum("bd,dhk->bhk", h, sp["wv"])
    q = rotary_embed(q[:, None], posb, cfg.rope_theta)[:, 0]
    k_new = rotary_embed(k_new[:, None], posb, cfg.rope_theta)[:, 0]
    ck.index_copy_(2, slot, k_new.to(ck.dtype)[:, :, None])
    cv.index_copy_(2, slot, v_new.to(cv.dtype)[:, :, None])
    o = attn_impl(q, ck, cv, slot_pos, pos, cfg.window)
    x = x + torch.einsum("bhk,hkd->bd", o, sp["wo"])
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, sp["w_gate"], sp["w_up"], sp["w_down"])
