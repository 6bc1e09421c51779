"""Decoder-only transformer LM: GQA, RoPE, RMSNorm, SWA, MoE, VLM prefix.

One implementation covers the dense (internlm2, deepseek-67b, h2o-danube),
MoE (qwen3-moe, mixtral) and VLM-backbone (internvl2) architectures, as in
the JAX package.  Layer weights are stacked along a leading ``layers`` axis
and cast to bf16 once per call; the layer loop is a Python loop over that
axis.  Activations run in bf16 from the embedding on, casts placed where
the JAX package places them.  The JAX package's sharding annotations stand
where it places them (:func:`~repro_torch.parallel.sharding.shard`, the
identity on values); under an active mesh with a ``model`` axis of more
than one device the MoE of prefill and of the full forward takes
:func:`~repro_torch.parallel.moe.moe_ffn_sharded`, while a decode step
keeps :func:`moe_ffn`, as in the JAX package.

The functions take the parameters as a nested dict of tensors
(:meth:`repro_torch.models.api.ModelBundle.init`); :class:`Transformer`
holds the same tree as an ``nn.Module``.  Decoding writes the new token's
keys and values into the cache tensors in place (the JAX package returns a
new cache); the returned cache dict holds the same tensors.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.common import ArchConfig
from repro_torch.models.layers import (P, bf16_layers, checkpointed,
                                       cross_entropy, embed_rows,
                                       flash_attention, layer_list,
                                       rms_norm, rotary_embed, silu, swiglu)
from repro_torch.parallel.sharding import active_mesh, shard


# ----------------------------------------------------------------- specs

def transformer_specs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    h, kh, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layer: dict[str, P] = {
        "ln1": P((L, d), ("layers", "embed"), "ones"),
        "ln2": P((L, d), ("layers", "embed"), "ones"),
        "wq": P((L, d, h, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": P((L, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": P((L, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": P((L, h, hd, d), ("layers", "heads", "head_dim", "embed")),
    }
    if cfg.n_experts:
        e, eff = cfg.n_experts, cfg.d_ff
        layer.update({
            "router": P((L, d, e), ("layers", "embed", "experts")),
            "we_gate": P((L, e, d, eff), ("layers", "experts", "expert_embed", "expert_mlp")),
            "we_up": P((L, e, d, eff), ("layers", "experts", "expert_embed", "expert_mlp")),
            "we_down": P((L, e, eff, d), ("layers", "experts", "expert_mlp", "expert_embed")),
        })
    else:
        layer.update({
            "w_gate": P((L, d, cfg.d_ff), ("layers", "embed", "mlp")),
            "w_up": P((L, d, cfg.d_ff), ("layers", "embed", "mlp")),
            "w_down": P((L, cfg.d_ff, d), ("layers", "mlp", "embed")),
        })
    return {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "embed", scale=0.02),
        "lm_head": P((d, cfg.vocab_size), ("embed", "vocab")),
        "ln_f": P((d,), ("embed",), "ones"),
        "layers": layer,
    }


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights out of the stacked ``[L, ...]`` tree (views)."""
    return {k: v[i] for k, v in layers.items()}


# ----------------------------------------------------------------- MoE FFN

def moe_dispatch(probs: torch.Tensor, cfg: ArchConfig,
                 capacity_factor: float = 1.25) -> dict:
    """Top-k routing with sort-based static-capacity dispatch, for router
    probabilities ``probs`` [t, e] (float32).

    The (token, k) pairs are sorted by expert, stably (ties keep pair
    order, as ``jnp.argsort``); a pair's place within its expert is its
    sorted index less the first index of its expert (``searchsorted`` on
    the left), and pairs past the expert's capacity are dropped.  Returns
    ``gate`` and ``expert_idx`` [t, k], ``cap``, and per sorted pair
    ``order``, ``slot``, ``keep`` and ``token_of`` [t*k].
    """
    t, e = probs.shape
    k = cfg.top_k
    gate, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)  # [t, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = int(2 ** math.ceil(math.log2(max(t * k / e * capacity_factor, 1))))
    cap = min(cap, t)
    flat_e = expert_idx.reshape(-1)                             # [t*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    grp_start = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(t * k, device=probs.device) - grp_start
    return {"gate": gate, "expert_idx": expert_idx, "cap": cap,
            "order": order, "slot": sorted_e * cap + pos_in_e,
            "keep": pos_in_e < cap, "token_of": order // k}


def moe_ffn(x: torch.Tensor, lp: dict, cfg: ArchConfig,
            capacity_factor: float = 1.25):
    """Token-choice top-k MoE with sort-based static-capacity dispatch.

    x: [B, S, d].  Returns (y, aux_loss).  Each kept pair is copied into its
    own slot of an ``[e * cap + 1, d]`` buffer; every dropped pair goes to
    the last row, which is cut off (the JAX package's scatter drops the
    out-of-range index ``e * cap``; ``index_add_`` would raise on it).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    logits = (xf @ lp["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    r = moe_dispatch(probs, cfg, capacity_factor)
    cap, order, keep = r["cap"], r["order"], r["keep"]
    slot, token_of = r["slot"], r["token_of"]
    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, r["expert_idx"].reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=x.device))
    aux = e * torch.sum(me * ce)
    # dispatch: [e*cap, d]
    disp = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    disp = disp.index_add(0, torch.where(keep, slot, e * cap), xf[token_of])
    disp = shard(disp[:e * cap].reshape(e, cap, d), "act_experts",
                 "act_expert_cap", "act_embed")
    # expert FFN
    g = silu(torch.bmm(disp, lp["we_gate"]))
    u = torch.bmm(disp, lp["we_up"])
    out = torch.bmm(g * u, lp["we_down"])
    out = shard(out, "act_experts", "act_expert_cap", "act_embed").reshape(
        e * cap, d)
    # combine
    w = (keep * r["gate"].reshape(-1)[order])[:, None].to(x.dtype)
    contrib = out[torch.where(keep, slot, 0)] * w
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, token_of, contrib)
    return y.reshape(b, s, d), aux


# ------------------------------------------------------------- layer body

def _attn_block(x: torch.Tensor, lp: dict, cfg: ArchConfig,
                positions: torch.Tensor, q_chunk: int, kv_chunk: int):
    """Pre-norm attention with its residual.  Returns the new ``x`` and the
    layer's roped keys and values [B, S, KH, hd] (what prefill caches)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    kk = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    q = shard(q, "act_batch", "act_seq", "act_heads", "act_head_dim")
    kk = shard(kk, "act_batch", "act_seq", "act_kv_heads", "act_head_dim")
    q = rotary_embed(q, positions, cfg.rope_theta)
    kk = rotary_embed(kk, positions, cfg.rope_theta)
    o = flash_attention(q, kk, v, causal=True, window=cfg.window,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    o = torch.einsum("bshk,hkd->bsd", o, lp["wo"])
    return x + shard(o, "act_batch", "act_seq", "act_embed"), kk, v


def _ffn_block(x: torch.Tensor, lp: dict, cfg: ArchConfig):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        # under an active multi-device mesh with a model axis, the meshed
        # MoE (locality-exact dispatch, one psum); else the one-device one
        mesh = active_mesh()
        if mesh is not None and "model" in mesh.axis_names \
                and mesh.size > 1:
            from repro_torch.parallel.moe import moe_ffn_sharded
            y, aux = moe_ffn_sharded(h, lp, cfg, mesh)
        else:
            y, aux = moe_ffn(h, lp, cfg)
    else:
        y = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        y = shard(y, "act_batch", "act_seq", "act_embed")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def transformer_layer(x, lp, cfg: ArchConfig, positions, q_chunk=512,
                      kv_chunk=512):
    x, _, _ = _attn_block(x, lp, cfg, positions, q_chunk, kv_chunk)
    return _ffn_block(x, lp, cfg)


def _embed_prefix(x: torch.Tensor, image_embeds) -> torch.Tensor:
    """The VLM prefix: the first ``n_image_embeds`` positions of ``x`` are
    the image-patch embeddings, cast to ``x``'s type."""
    if image_embeds is None:
        return x
    n = image_embeds.shape[1]
    return torch.cat([image_embeds.to(x.dtype), x[:, n:]], dim=1)


# ------------------------------------------------------------- full forward

def transformer_logits(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                       image_embeds: torch.Tensor | None = None,
                       q_chunk: int = 1024, kv_chunk: int = 2048,
                       remat: bool = True):
    """Full-sequence forward.  tokens [B, S] -> (logits [B, S, V], aux).
    The embedding is scaled by sqrt(d_model) in the parameters' type, then
    cast to bf16.  With ``remat`` (and grad on) each layer body, attention
    block, FFN or MoE and the running ``aux``, is rematerialised, as the
    JAX package's ``jax.checkpoint(body)``: the backward keeps each layer's
    input, not its activations.  The values do not depend on ``remat``."""
    b, s = tokens.shape
    x = embed_rows(params["embed"], tokens) * math.sqrt(cfg.d_model)
    x = _embed_prefix(x.to(torch.bfloat16), image_embeds)
    x = shard(x, "act_batch", "act_seq", "act_embed")
    positions = torch.arange(s, device=x.device).expand(b, s)

    def body(xx, aux, lp):
        xx, a = transformer_layer(xx, lp, cfg, positions, q_chunk, kv_chunk)
        return xx, aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_list(bf16_layers(params["layers"])):
        x, aux = checkpointed(body, x, aux, lp, enabled=remat)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(torch.bfloat16)
    return shard(logits, "act_batch", "act_seq", "act_vocab"), aux


def transformer_loss(params, cfg: ArchConfig, batch: dict,
                     q_chunk: int = 1024, kv_chunk: int = 2048):
    toks = batch["tokens"]
    inputs, targets = toks[:, :-1], toks[:, 1:]
    logits, aux = transformer_logits(params, cfg, inputs,
                                     batch.get("image_embeds"),
                                     q_chunk, kv_chunk)
    return cross_entropy(logits, targets) + 0.01 * aux


# ------------------------------------------------------------------ decode

def cache_spec(cfg: ArchConfig, batch: int, cache_len: int):
    """The KV cache tree as meta tensors (shape and dtype), and its logical
    axes.  An SWA architecture keeps a ring buffer of ``window`` slots."""
    hd = cfg.resolved_head_dim()
    clen = min(cache_len, cfg.window) if cfg.window else cache_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, clen, hd)
    axes = ("layers", "cache_batch", "cache_kv_heads", "cache_seq",
            "act_head_dim")
    spec = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    return {"k": spec, "v": spec}, {"k": axes, "v": axes}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda"):
    spec, _ = cache_spec(cfg, batch, cache_len)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def _cache_positions(cfg: ArchConfig, clen: int,
                     pos: torch.Tensor) -> torch.Tensor:
    """Absolute position held by each cache slot (ring buffer for SWA);
    ``pos`` a 0-d integer tensor.  ``torch.remainder`` is a floor modulo,
    as JAX's ``%``: a slot not yet written gives a negative position."""
    idx = torch.arange(clen, device=pos.device)
    if cfg.window:
        # slot i holds the largest p <= pos with p % clen == i
        p = pos - torch.remainder(pos - idx, clen)
        return torch.where(p < 0, -1, p)
    return torch.where(idx <= pos, idx, -1)


def _decode_position(cfg: ArchConfig, pos, ck: torch.Tensor):
    """A decode step's position as a 0-d int64 tensor on the cache's
    device, and the cache slot [1] it writes.  ``pos`` is a Python int or
    a 0-d integer tensor (on the cache's device, or the step reads it
    back); ``ck`` is a ``[..., C, hd]`` cache of C slots.

    A Python ``pos`` becomes a device scalar by a fill, not a copy.  A
    full-attention cache holds positions below its length: a Python
    ``pos`` past it raises, a tensor one writes the last slot, as the JAX
    package's clamped ``dynamic_update_slice`` does; an SWA ring buffer
    writes slot ``pos % C``."""
    dev, clen = ck.device, ck.shape[-2]
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=dev, dtype=torch.int64)
    elif not cfg.window and not 0 <= pos < clen:
        raise ValueError(f"position {pos} is outside a cache of {clen} "
                         f"slots")
    else:
        pos = torch.full((), pos, dtype=torch.int64, device=dev)
    slot = (torch.remainder(pos, clen) if cfg.window
            else torch.clamp(pos, 0, clen - 1)).reshape(1)
    return pos, slot


def decode_attention(q, ck, cv, slot_pos, pos, window, scale=None):
    """q [B,H,hd]; ck/cv [B,KH,C,hd]; slot_pos [C] absolute positions, -1
    invalid.  Plain attention over the cache: scores in q's type, softmax in
    float32, probabilities cast back.  ``scale`` multiplies the scores
    (default: they are divided by ``sqrt(hd)``)."""
    b, h, hd = q.shape
    kh = ck.shape[1]
    g = h // kh
    qr = q.reshape(b, kh, g, hd)
    s = torch.einsum("bhgd,bhcd->bhgc", qr, ck.to(qr.dtype))
    s = s / math.sqrt(hd) if scale is None else s * scale
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= (pos - slot_pos) < window
    s = s.masked_fill(~valid[None, None, None, :], -math.inf)
    p = torch.softmax(s.float(), dim=-1).to(qr.dtype)
    o = torch.einsum("bhgc,bhcd->bhgd", p, cv.to(qr.dtype))
    return o.reshape(b, h, hd)


def transformer_decode_step(params: dict, cfg: ArchConfig, cache: dict,
                            tokens: torch.Tensor, pos,
                            attn_impl=decode_attention):
    """One decode step.  tokens [B] int; ``pos`` the next position, a
    Python int or a 0-d integer tensor (on the cache's device, or the step
    reads it back).

    Returns (logits [B, V], cache), the cache written in place.  Nothing is
    read back to the host (:func:`_decode_position`).
    """
    b = tokens.shape[0]
    clen = cache["k"].shape[3]
    pos, slot = _decode_position(cfg, pos, cache["k"])
    slot_pos = _cache_positions(cfg, clen, pos)
    posb = pos.expand(b, 1)
    x = embed_rows(params["embed"], tokens) * math.sqrt(cfg.d_model)
    x = shard(x.to(torch.bfloat16), "act_batch", "act_embed")
    layers = bf16_layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
        k_new = torch.einsum("bd,dhk->bhk", h, lp["wk"])
        v_new = torch.einsum("bd,dhk->bhk", h, lp["wv"])
        q = rotary_embed(q[:, None], posb, cfg.rope_theta)[:, 0]
        k_new = rotary_embed(k_new[:, None], posb, cfg.rope_theta)[:, 0]
        ck.index_copy_(2, slot, k_new.to(ck.dtype)[:, :, None])
        cv.index_copy_(2, slot, v_new.to(cv.dtype)[:, :, None])
        o = attn_impl(q, ck, cv, slot_pos, pos, cfg.window)
        x = x + torch.einsum("bhk,hkd->bd", o, lp["wo"])
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            y, _ = moe_ffn(h2[:, None], lp, cfg)
            y = y[:, 0]
        else:
            y = swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])
        x = shard(x + y, "act_batch", "act_embed")
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(torch.bfloat16)
    return shard(logits, "act_batch", "act_vocab"), cache


def transformer_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                        image_embeds: torch.Tensor | None = None,
                        q_chunk: int = 512, kv_chunk: int = 512):
    """Prefill: one pass that emits the KV cache (the artifact a serving
    system keeps) per layer and the last position's logits.  The embedding
    is cast to bf16 first, then scaled by sqrt(d_model).

    SWA archs keep only the last ``window`` positions, ring-buffer-aligned
    with :func:`transformer_decode_step`'s slot convention (slot = pos %
    window).
    """
    b, s = tokens.shape
    x = embed_rows(params["embed"], tokens).to(torch.bfloat16) * \
        math.sqrt(cfg.d_model)
    x = shard(_embed_prefix(x, image_embeds), "act_batch", "act_seq",
              "act_embed")
    positions = torch.arange(s, device=x.device).expand(b, s)
    layers = bf16_layers(params["layers"])
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x, kk, vv = _attn_block(x, lp, cfg, positions, q_chunk, kv_chunk)
        x, _ = _ffn_block(x, lp, cfg)
        ck = kk.transpose(1, 2)            # [B, KH, S, hd]
        cv = vv.transpose(1, 2)
        if cfg.window and cfg.window < s:
            w = cfg.window
            ck = torch.roll(ck[:, :, -w:], shifts=s % w, dims=2)
            cv = torch.roll(cv[:, :, -w:], shifts=s % w, dims=2)
        ks.append(shard(ck.to(torch.bfloat16), "cache_batch",
                        "cache_kv_heads", "cache_seq", "act_head_dim"))
        vs.append(shard(cv.to(torch.bfloat16), "cache_batch",
                        "cache_kv_heads", "cache_seq", "act_head_dim"))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ params["lm_head"].to(torch.bfloat16)
    return (shard(logits, "act_batch", "act_vocab"),
            {"k": torch.stack(ks), "v": torch.stack(vs)})


# ------------------------------------------------------------ as a module

class Transformer(nn.Module):
    """The LM as an ``nn.Module``: the parameter tree's leaves are its
    parameters (``layers`` a ``ParameterDict`` of the stacked weights), its
    forward is :func:`transformer_logits`.  The parameters share storage
    with the tree it is built from."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.lm_head = nn.Parameter(params["lm_head"])
        self.ln_f = nn.Parameter(params["ln_f"])
        self.layers = nn.ParameterDict(params["layers"])

    def tree(self) -> dict:
        """The parameters as the functions of this module take them."""
        return {"embed": self.embed, "lm_head": self.lm_head,
                "ln_f": self.ln_f, "layers": dict(self.layers)}

    def forward(self, tokens: torch.Tensor,
                image_embeds: torch.Tensor | None = None):
        return transformer_logits(self.tree(), self.cfg, tokens,
                                  image_embeds)
