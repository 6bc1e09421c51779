"""Whisper-style encoder-decoder backbone in PyTorch (arXiv:2212.04356).

The conv/mel frontend is a stub, as in the JAX package: the model takes
precomputed frame embeddings [B, S_enc, d_model].  The backbone: sinusoidal
positions, a pre-norm bidirectional encoder, a decoder with causal
self-attention, cross-attention and a GELU MLP, and an LM head tied to the
embedding.  GELU is the tanh approximation (``jax.nn.gelu``'s default),
computed step for step as JAX does (:func:`gelu_tanh`).

prefill: encode + decoder prefill over the prompt -> (self + cross caches).
decode:  one decoder token against the self cache and the cross cache; the
         new token's keys and values are written into the self cache in
         place, and the returned cache dict holds the same tensors.

The encoder's self-attention and the prefill's cross-attention mask the
zero keys that pad the last kv chunk (:func:`flash_attention`); the JAX
package's flash attention counts them whenever ``S_enc > 512`` is not a
multiple of 512, so at Whisper's native 1500 frames the two differ there.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.layers import (P, bf16_layers, checkpointed,
                                       cross_entropy, embed_rows,
                                       flash_attention, gelu_tanh,
                                       init_params, layer_list, param_axes,
                                       rms_norm, weak_const)
from repro_torch.models.transformer import (_cache_positions,
                                            _decode_position, _layer,
                                            decode_attention)


def _hd(cfg):
    return cfg.resolved_head_dim()


def whisper_specs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, _hd(cfg)
    h, kh = cfg.n_heads, cfg.n_kv_heads
    le, ld = cfg.n_encoder_layers or cfg.n_layers, cfg.n_layers

    def attn(L):
        return {
            "wq": P((L, d, h, hd), ("layers", "embed", "heads", "head_dim")),
            "wk": P((L, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "wv": P((L, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "wo": P((L, h, hd, d), ("layers", "heads", "head_dim", "embed")),
        }

    def mlp(L):
        return {
            "w_in": P((L, d, cfg.d_ff), ("layers", "embed", "mlp")),
            "w_out": P((L, cfg.d_ff, d), ("layers", "mlp", "embed")),
        }

    enc = {"ln1": P((le, d), ("layers", "embed"), "ones"),
           "ln2": P((le, d), ("layers", "embed"), "ones"),
           **attn(le), **mlp(le)}
    dec = {"ln1": P((ld, d), ("layers", "embed"), "ones"),
           "ln2": P((ld, d), ("layers", "embed"), "ones"),
           "ln3": P((ld, d), ("layers", "embed"), "ones"),
           **attn(ld),
           "xwq": P((ld, d, h, hd), ("layers", "embed", "heads", "head_dim")),
           "xwk": P((ld, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
           "xwv": P((ld, d, kh, hd), ("layers", "embed", "kv_heads", "head_dim")),
           "xwo": P((ld, h, hd, d), ("layers", "heads", "head_dim", "embed")),
           **mlp(ld)}
    return {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "embed", scale=0.02),
        "ln_enc": P((d,), ("embed",), "ones"),
        "ln_dec": P((d,), ("embed",), "ones"),
        "encoder": enc,
        "decoder": dec,
    }


def init_whisper(generator: torch.Generator, cfg: ArchConfig,
                 dtype=torch.float32, device="cuda"):
    return init_params(generator, whisper_specs(cfg), dtype, device)


def whisper_axes(cfg: ArchConfig):
    return param_axes(whisper_specs(cfg))


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal positions [s, d] in float32: sines, then cosines."""
    pos = torch.arange(s, device=device)[:, None].float()
    i = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoid [d] of one position, a 0-d tensor (on its device)."""
    i = torch.arange(d // 2, device=pos.device).float()
    ang = pos.float() / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def _gelu_mlp(x, lp, cfg):
    """The MLP with its residual: ``ln2`` in the encoder, ``ln3`` in the
    decoder (which has one)."""
    h = rms_norm(x, lp["ln3"] if "ln3" in lp else lp["ln2"], cfg.norm_eps)
    y = gelu_tanh(h @ lp["w_in"])
    return x + y @ lp["w_out"]


def _self_attn(x, lp, cfg, causal, q_chunk=512, kv_chunk=512):
    """Self-attention with its residual.  Returns the new ``x`` and the
    keys and values [B, S, KH, hd] (what prefill caches)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    o = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
    return x + torch.einsum("bshk,hkd->bsd", o, lp["wo"]), k, v


def _cross_attn(x, enc_out, lp, cfg, q_chunk=512, kv_chunk=512):
    """Cross-attention on the encoder states with its residual.  Returns
    the new ``x`` and the cross keys and values [B, S_enc, KH, hd]."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, lp["xwq"])
    k = torch.einsum("bsd,dhk->bshk", enc_out, lp["xwk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, lp["xwv"])
    o = flash_attention(q, k, v, causal=False, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
    return x + torch.einsum("bshk,hkd->bsd", o, lp["xwo"]), k, v


def whisper_encode(params, cfg: ArchConfig, frames: torch.Tensor,
                   remat: bool = True) -> torch.Tensor:
    """frames [B, S_enc, d] (stub frontend output) -> encoder states.  The
    frames and the sinusoid are summed in float32, then cast to bf16.  With
    ``remat`` (and grad on) each layer is rematerialised, as the JAX
    package's ``jax.checkpoint(body)``."""
    _, s, d = frames.shape
    x = (frames.float() + _sinusoid(s, d, frames.device)[None]).to(
        torch.bfloat16)

    def body(xx, lp):
        return _gelu_mlp(_self_attn(xx, lp, cfg, causal=False)[0], lp, cfg)

    for lp in layer_list(bf16_layers(params["encoder"])):
        x = checkpointed(body, x, lp, enabled=remat)
    return rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's input: the scaled bf16 embedding rows, then the bf16
    sinusoid of positions 0..S-1 added."""
    s, d = tokens.shape[1], cfg.d_model
    return _scaled_embed(params, d, tokens) + _sinusoid(
        s, d, tokens.device)[None].to(torch.bfloat16)


def _scaled_embed(params, d: int, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows in bf16 times sqrt(d) rounded to bf16 (the JAX
    package's weak-typed constant)."""
    return embed_rows(params["embed"], tokens).to(torch.bfloat16) * \
        weak_const(math.sqrt(d), torch.bfloat16)


def _head(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """``ln_dec``, then the head tied to the embedding."""
    x = rms_norm(x, params["ln_dec"], cfg.norm_eps)
    return x @ params["embed"].to(torch.bfloat16).T


def whisper_decoder_logits(params, cfg: ArchConfig, tokens: torch.Tensor,
                           enc_out: torch.Tensor,
                           remat: bool = True) -> torch.Tensor:
    """The decoder's logits over ``enc_out``; with ``remat`` (and grad on)
    each layer is rematerialised, as in :func:`whisper_encode`."""
    x = _embed(params, cfg, tokens)

    def body(xx, lp):
        xx = _self_attn(xx, lp, cfg, causal=True)[0]
        xx = _cross_attn(xx, enc_out, lp, cfg)[0]
        return _gelu_mlp(xx, lp, cfg)

    for lp in layer_list(bf16_layers(params["decoder"])):
        x = checkpointed(body, x, lp, enabled=remat)
    return _head(params, cfg, x)


def whisper_loss(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    enc_out = whisper_encode(params, cfg, batch["frames"])
    toks = batch["tokens"]
    logits = whisper_decoder_logits(params, cfg, toks[:, :-1], enc_out)
    return cross_entropy(logits, toks[:, 1:])


# ------------------------------------------------------------------ decode

def whisper_cache_spec(cfg: ArchConfig, batch: int, cache_len: int):
    """The self cache (``cache_len`` slots) and the cross cache
    (``cross_len``) as meta tensors, and their logical axes."""
    hd = _hd(cfg)
    ld = cfg.n_layers
    self_kv = torch.empty((ld, batch, cfg.n_kv_heads, cache_len, hd),
                          dtype=torch.bfloat16, device="meta")
    cross_kv = torch.empty((ld, batch, cfg.n_kv_heads, cfg.cross_len, hd),
                           dtype=torch.bfloat16, device="meta")
    ax = ("layers", "cache_batch", "cache_kv_heads", "cache_seq",
          "act_head_dim")
    cax = ("layers", "cache_batch", "cache_kv_heads", "act_seq",
           "act_head_dim")
    return ({"k": self_kv, "v": self_kv, "xk": cross_kv, "xv": cross_kv},
            {"k": ax, "v": ax, "xk": cax, "xv": cax})


def init_whisper_cache(cfg: ArchConfig, batch: int, cache_len: int,
                       device="cuda"):
    spec, _ = whisper_cache_spec(cfg, batch, cache_len)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def whisper_decode_step(params, cfg: ArchConfig, cache: dict,
                        tokens: torch.Tensor, pos,
                        attn_impl=decode_attention):
    """One decoder token.  tokens [B] int; ``pos`` a Python int or a 0-d
    integer tensor (:func:`~repro_torch.models.transformer._decode_position`).
    The cross-attention counts every slot of the cross cache, as the JAX
    package's position ``2**30`` does.  Returns (logits [B, V], cache), the
    self cache written in place."""
    d = cfg.d_model
    clen = cache["k"].shape[3]
    pos, slot = _decode_position(cfg, pos, cache["k"])
    slot_pos = _cache_positions(cfg, clen, pos)
    cross_pos = torch.arange(cache["xk"].shape[3], device=pos.device)
    every = torch.full((), 2 ** 30, dtype=torch.int64, device=pos.device)
    x = _scaled_embed(params, d, tokens) + _sinusoid_at(pos, d).to(
        torch.bfloat16)
    layers = bf16_layers(params["decoder"])
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = torch.einsum("bd,dhk->bhk", h, lp["wq"])
        k_new = torch.einsum("bd,dhk->bhk", h, lp["wk"])
        v_new = torch.einsum("bd,dhk->bhk", h, lp["wv"])
        ck.index_copy_(2, slot, k_new.to(ck.dtype)[:, :, None])
        cv.index_copy_(2, slot, v_new.to(cv.dtype)[:, :, None])
        o = attn_impl(q, ck, cv, slot_pos, pos, None)
        x = x + torch.einsum("bhk,hkd->bd", o, lp["wo"])
        # cross attention against the (precomputed) encoder cache
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        q2 = torch.einsum("bd,dhk->bhk", h2, lp["xwq"])
        o2 = attn_impl(q2, cache["xk"][i], cache["xv"][i], cross_pos, every,
                       None)
        x = x + torch.einsum("bhk,hkd->bd", o2, lp["xwo"])
        h3 = rms_norm(x, lp["ln3"], cfg.norm_eps)
        y = gelu_tanh(h3 @ lp["w_in"])
        x = x + y @ lp["w_out"]
    return _head(params, cfg, x), cache


def whisper_prefill(params, cfg: ArchConfig, frames: torch.Tensor,
                    tokens: torch.Tensor):
    """Encode ``frames`` and prefill the decoder prompt.  Returns (last
    logits, cache): the self cache filled to ``len(tokens)`` and the cross
    caches over the encoder's ``S_enc`` states, each [L, B, KH, S, hd]."""
    enc_out = whisper_encode(params, cfg, frames, remat=False)
    x = _embed(params, cfg, tokens)
    layers = bf16_layers(params["decoder"])
    kv = {"k": [], "v": [], "xk": [], "xv": []}
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x, k, v = _self_attn(x, lp, cfg, causal=True)
        x, xk, xv = _cross_attn(x, enc_out, lp, cfg)
        x = _gelu_mlp(x, lp, cfg)
        for name, t in zip(kv, (k, v, xk, xv)):
            kv[name].append(t.transpose(1, 2).to(torch.bfloat16))
    logits = _head(params, cfg, x[:, -1])
    return logits, {name: torch.stack(ts) for name, ts in kv.items()}
