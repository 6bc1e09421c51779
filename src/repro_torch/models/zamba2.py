"""Zamba2 in PyTorch: a Mamba2 backbone plus *shared* attention blocks
(arXiv:2411.15242), in two layouts.

The JAX package's simplified one (``hybrid_period``, Zamba2-2.7B's
config): one shared attention + FFN block, with its residual, applied
after every ``hybrid_period`` SSM layers.  The shared block's weights are
one parameter set, cast to bf16 once per call and reused at every
application; each application keeps its own KV cache slice
``[n_outer, B, KH, clen, hd]``.  The 54 stacked mamba layers are grouped
as (n_outer, period); the outer loop runs a group's mamba layers, then
the shared attention + FFN block.

The published one (``hybrid_layer_ids``, Zamba2-7B-Instruct's
:class:`~repro_torch.configs.zamba2_7b.Zamba2Config`): at each listed
layer, shared block ``k % n_mem_blocks`` reads ``concat(x, embedding)``,
attends with its softmax scaled by ``(head_dim / 2) ** -0.5``, runs its
gated exact-GELU MLP with the application's LoRA on the gate and up
projections, with no residual inside, and the application's linear maps
its output onto the mixer's input (not the residual stream).  The mixers
are :func:`~repro_torch.models.mamba2.mixer_block`'s (groups, conv bias,
grouped gated norm), the head is tied to the unscaled embedding, and
prefill hands decode the true conv tails: prefill followed by decode is
the full forward.  Each mixer call is a ``lm.mamba`` stage span and each
shared application a ``lm.shared_block`` one; block listeners
(:func:`add_block_listener`) see every block's inputs and output.

Decode writes the states and the new keys and values into the cache
tensors in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.core.pytree import tree_map
from repro_torch.models.layers import (P, bf16_layers, checkpointed,
                                       cross_entropy, embed_rows,
                                       flash_attention, geglu, init_params,
                                       layer_list, param_axes, rms_norm,
                                       rotary_embed, swiglu)
from repro_torch.models.mamba2 import (_embed, mamba2_block,
                                       mamba2_block_decode,
                                       mamba2_cache_spec,
                                       mamba2_layer_specs, mixer_block,
                                       mixer_block_decode, mixer_cache_spec,
                                       mixer_f32_leaves, mixer_layer_specs)
from repro_torch.models.transformer import (_cache_positions,
                                            _decode_position,
                                            decode_attention)
from repro_torch.stage_spans import span


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
    mamba = layer_list(bf16_layers(params["mamba"]))
    return [mamba[g * period:(g + 1) * period] for g in range(n_outer)]


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


def zamba2_logits(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """Full-sequence forward; with ``remat`` (and grad on) each outer group,
    ``period`` mamba blocks and the shared block, is rematerialised, as the
    JAX package's ``jax.checkpoint(outer_body)``."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    shared = _shared(params)

    def outer_body(xx, group):
        for lp in group:
            xx = mamba2_block(xx, lp, cfg)[0]
        return _shared_block(xx, shared, cfg, positions)[0]

    for group in _group_params(params, cfg):
        x = checkpointed(outer_body, x, group, enabled=remat)
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


# ------------------------------------------- the published layout (7B)

_block_listeners: list = []


def add_block_listener(fn) -> None:
    """Subscribe ``fn(kind, index, inputs, output)`` to every block of the
    published layout as it runs: ``("mamba", layer, (h_in,), update)``
    with the mixer's input (``x + t`` at a hybrid layer) and its update
    of ``x``; ``("shared", application, (x, e), t)`` with the block's
    inputs and its output through the application's linear; ``("head",
    0, (x,), logits)`` with the final hidden state before its norm.
    Prefill passes ``[B, S, ...]`` tensors, decode ``[B, ...]``.  With no
    listener, a block costs one list test."""
    if fn not in _block_listeners:
        _block_listeners.append(fn)


def remove_block_listener(fn) -> None:
    if fn in _block_listeners:
        _block_listeners.remove(fn)


def decode_capturable() -> bool:
    """Whether a decode step of the published layout may be captured as
    a CUDA graph now: it reads nothing back, and only a block listener
    would run host code inside it."""
    return not _block_listeners


def _notify(kind: str, index: int, inputs: tuple, output) -> None:
    for fn in list(_block_listeners):
        fn(kind, index, inputs, output)


def hybrid_specs(cfg) -> dict:
    """The published layout's weights: the tied embedding, the final norm,
    the stacked mixers, the ``n_mem_blocks`` shared blocks (stacked) and
    each application's LoRA and linear (stacked).  Norm weights are drawn
    around 1 (none is 1), so that leaving one out changes the output."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    hq = cfg.n_heads * cfg.resolved_head_dim()
    hk = cfg.n_kv_heads * cfg.resolved_head_dim()
    nb, na, ai = cfg.n_mem_blocks, cfg.n_apps, cfg.attn_in
    norm = dict(scale=0.1, mean=1.0)
    return {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "embed"),
        "ln_f": P((d,), ("embed",), **norm),
        "mamba": mixer_layer_specs(cfg),
        "shared": {
            "ln1": P((nb, ai), ("layers", "embed"), **norm),
            "wq": P((nb, ai, hq), ("layers", "embed", "heads")),
            "wk": P((nb, ai, hk), ("layers", "embed", "kv_heads")),
            "wv": P((nb, ai, hk), ("layers", "embed", "kv_heads")),
            "wo": P((nb, hq, d), ("layers", "heads", "embed")),
            "ln2": P((nb, d), ("layers", "embed"), **norm),
            "w_gu": P((nb, d, 2 * f), ("layers", "embed", "mlp")),
            "w_down": P((nb, f, d), ("layers", "mlp", "embed")),
        },
        "apps": {
            "lora_a": P((na, d, r), ("layers", "embed", None)),
            "lora_b": P((na, r, 2 * f), ("layers", None, "mlp")),
            "linear": P((na, d, d), ("layers", "embed", "embed")),
        },
    }


def _attn_scale(cfg) -> float:
    """The shared attention's softmax scale, ``(head_dim / 2) ** -0.5``."""
    return (cfg.resolved_head_dim() / 2) ** -0.5


def _concat(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The shared block's input: the residual stream beside the
    embedding."""
    return torch.cat([x, e], dim=-1)


def _lora(m: torch.Tensor, ap: dict) -> torch.Tensor:
    return (m @ ap["lora_a"]) @ ap["lora_b"]


def _shared_mlp(o: torch.Tensor, sp: dict, ap: dict, cfg) -> torch.Tensor:
    """The block's second half on the attention's projected output ``o``
    (no residual): norm, gate and up with the application's LoRA, exact
    GELU, down, then the application's linear."""
    m = rms_norm(o, sp["ln2"], cfg.norm_eps)
    return geglu(m @ sp["w_gu"] + _lora(m, ap), sp["w_down"]) @ ap["linear"]


def _shared_apply(x, e, sp, ap, cfg, positions, q_chunk=512, kv_chunk=512):
    """One shared-block application over a full sequence.  x, e [B, S, d].
    Returns its output ``t`` [B, S, d] and the roped keys and the values
    [B, S, KH, hd] (what prefill caches)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    a = rms_norm(_concat(x, e), sp["ln1"], cfg.norm_eps)
    q = (a @ sp["wq"]).view(b, s, cfg.n_heads, hd)
    k = (a @ sp["wk"]).view(b, s, cfg.n_kv_heads, hd)
    v = (a @ sp["wv"]).view(b, s, cfg.n_kv_heads, hd)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, scale=_attn_scale(cfg))
    return _shared_mlp(o.reshape(b, s, -1) @ sp["wo"], sp, ap, cfg), k, v


def _shared_apply_decode(x, e, sp, ap, cfg, ck, cv, pos, slot, slot_pos,
                         attn_impl=decode_attention):
    """One token through a shared-block application.  x, e [B, d]; ``ck``
    / ``cv`` [B, KH, C, hd] the application's cache, the new key (roped)
    and value written into slot ``slot`` in place.  Returns ``t`` [B, d]."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    posb = pos.expand(b, 1)
    a = rms_norm(_concat(x, e), sp["ln1"], cfg.norm_eps)
    q = (a @ sp["wq"]).view(b, cfg.n_heads, hd)
    k = (a @ sp["wk"]).view(b, cfg.n_kv_heads, hd)
    v = (a @ sp["wv"]).view(b, cfg.n_kv_heads, hd)
    q = rotary_embed(q[:, None], posb, cfg.rope_theta)[:, 0]
    k = rotary_embed(k[:, None], posb, cfg.rope_theta)[:, 0]
    ck.index_copy_(2, slot, k.to(ck.dtype)[:, :, None])
    cv.index_copy_(2, slot, v.to(cv.dtype)[:, :, None])
    o = attn_impl(q, ck, cv, slot_pos, pos, cfg.window,
                  scale=_attn_scale(cfg))
    return _shared_mlp(o.reshape(b, -1) @ sp["wo"], sp, ap, cfg)


def _head(x: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    """The tied head: ``rms_norm(x) @ embed.T``."""
    logits = rms_norm(x, params["ln_f"], cfg.norm_eps) @ params["embed"].T
    if _block_listeners:
        _notify("head", 0, (x,), logits)
    return logits


def _hybrid_layers(params: dict, cfg, e: torch.Tensor, shared_fn,
                   mixer_fn) -> torch.Tensor:
    """The layer loop of the published layout from the embedding ``e``:
    at a hybrid layer ``t = shared_fn(k, x, block, application)`` (a
    ``lm.shared_block`` span) is added to the mixer's input; every layer
    adds ``mixer_fn(i, h_in, lp)`` (a ``lm.mamba`` span) to ``x``.
    Returns the final hidden state, before its norm."""
    mixers = layer_list(mixer_f32_leaves(params["mamba"]))
    blocks, apps = layer_list(params["shared"]), layer_list(params["apps"])
    app_of = {lid: k for k, lid in enumerate(cfg.hybrid_layer_ids)}
    x = e
    for i, lp in enumerate(mixers):
        h_in = x
        k = app_of.get(i)
        if k is not None:
            with span("lm.shared_block"):
                t = shared_fn(k, x, blocks[cfg.block_of(k)], apps[k])
            if _block_listeners:
                _notify("shared", k, (x, e), t)
            h_in = x + t
        with span("lm.mamba"):
            out = mixer_fn(i, h_in, lp)
        if _block_listeners:
            _notify("mamba", i, (h_in,), out)
        x = x + out
    return x


def _hybrid_forward(params: dict, cfg, tokens: torch.Tensor,
                    cache: dict | None = None) -> torch.Tensor:
    """The full forward of the published layout, in the parameters' type
    (bf16 as served; float32 in the tests): the final hidden state
    [B, S, d] before its norm.  With ``cache`` (tensors shaped by
    :func:`hybrid_cache_spec` for S positions), each mixer's final SSM
    state and conv tail and each application's keys and values are
    written into it."""
    b, s = tokens.shape
    e = embed_rows(params["embed"], tokens)
    positions = torch.arange(s, device=e.device).expand(b, s)

    def shared_fn(k, x, sp, ap):
        t, kk, vv = _shared_apply(x, e, sp, ap, cfg, positions)
        if cache is not None:
            cache["attn_k"][k].copy_(kk.transpose(1, 2))
            cache["attn_v"][k].copy_(vv.transpose(1, 2))
        return t

    def mixer_fn(i, h_in, lp):
        out, state, tail = mixer_block(h_in, lp, cfg)
        if cache is not None:
            cache["ssm"][i].copy_(state)
            cache["conv"][i].copy_(tail)
        return out

    return _hybrid_layers(params, cfg, e, shared_fn, mixer_fn)


def hybrid_logits(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Every position's logits [B, S, V] of the published layout."""
    return _head(_hybrid_forward(params, cfg, tokens), params, cfg)


def hybrid_loss(params, cfg, batch: dict) -> torch.Tensor:
    toks = batch["tokens"]
    return cross_entropy(hybrid_logits(params, cfg, toks[:, :-1]),
                         toks[:, 1:])


def hybrid_cache_spec(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16):
    """The mixers' SSM states (float32) and conv tails, and one KV slice
    per application ``[n_apps, B, KH, cache_len, hd]``, these in
    ``dtype`` (the parameters'), as meta tensors, and their logical
    axes."""
    spec, axes = mixer_cache_spec(cfg, batch, dtype)
    kv = torch.empty((cfg.n_apps, batch, cfg.n_kv_heads, cache_len,
                      cfg.resolved_head_dim()), dtype=dtype, device="meta")
    kv_axes = ("layers", "cache_batch", "cache_kv_heads", "cache_seq",
               "act_head_dim")
    spec.update(attn_k=kv, attn_v=kv)
    axes.update(attn_k=kv_axes, attn_v=kv_axes)
    return spec, axes


def hybrid_prefill(params: dict, cfg, tokens: torch.Tensor):
    """The full forward, writing the decode cache for the prompt's S
    positions: each mixer's SSM state and true conv tail, each
    application's roped keys and values.  Returns (last-token logits,
    cache)."""
    b, s = tokens.shape
    emb = params["embed"]
    spec, _ = hybrid_cache_spec(cfg, b, s, emb.dtype)
    cache = {k: torch.empty(v.shape, dtype=v.dtype, device=emb.device)
             for k, v in spec.items()}
    x = _hybrid_forward(params, cfg, tokens, cache)
    return _head(x[:, -1], params, cfg), cache


def hybrid_decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                       pos, attn_impl=decode_attention):
    """One decode step of the published layout.  tokens [B] int; ``pos`` a
    Python int or a 0-d integer tensor.  Returns (logits [B, V], cache),
    the cache written in place.  ``attn_impl`` takes a ``scale``."""
    clen = cache["attn_k"].shape[3]
    pos, slot = _decode_position(cfg, pos, cache["attn_k"])
    slot_pos = _cache_positions(cfg, clen, pos)
    e = embed_rows(params["embed"], tokens)

    def shared_fn(k, x, sp, ap):
        return _shared_apply_decode(x, e, sp, ap, cfg, cache["attn_k"][k],
                                    cache["attn_v"][k], pos, slot, slot_pos,
                                    attn_impl)

    def mixer_fn(i, h_in, lp):
        return mixer_block_decode(h_in, lp, cfg, cache["ssm"][i],
                                  cache["conv"][i])

    x = _hybrid_layers(params, cfg, e, shared_fn, mixer_fn)
    return _head(x, params, cfg), cache
