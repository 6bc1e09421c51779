"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch.

The SSD recurrence per head:  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t],
y[t] = C[t]·h[t] + D x[t]: the LIF membrane equation without a firing
threshold, the same leaky-integrator scan as the MENAGE core.

Chunked scan as in the JAX package: a Python loop over sequence chunks
carrying the inter-chunk state [B, H, P, N]; the intra-chunk work is the
masked quadratic-in-Q product (Q = ``ssm_chunk``), written as pairwise
batched matmuls so the peak buffer is O(B·H·Q²), never O(L²) and never the
5-D [B, Q, Q, H, P] product.  Decode is the O(1) recurrence; it writes the
SSM and conv states into the cache tensors in place (the JAX package
returns a new cache), and the returned cache dict holds the same tensors.

Types sit where the JAX package puts them: the forward's causal conv runs
in bf16 on bf16 weights, the decode step's in float32; the scan and the
``d_skip`` term run in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.models.layers import (P, bf16_layers, checkpointed,
                                       cross_entropy, embed_rows,
                                       init_params, layer_list, param_axes,
                                       rms_norm, silu, softplus, weak_const)
from repro_torch.models.transformer import _layer


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def mamba2_layer_specs(cfg: ArchConfig, n_layers: int | None = None) -> dict:
    d = cfg.d_model
    d_in, h, n, p = _dims(cfg)
    L = cfg.n_layers if n_layers is None else n_layers
    cw = cfg.ssm_conv_width
    return {
        "ln": P((L, d), ("layers", "embed"), "ones"),
        # in_proj -> [z, x, B, C, dt]
        "w_z": P((L, d, d_in), ("layers", "embed", "ssm_inner")),
        "w_x": P((L, d, d_in), ("layers", "embed", "ssm_inner")),
        "w_b": P((L, d, n), ("layers", "embed", "ssm_state")),
        "w_c": P((L, d, n), ("layers", "embed", "ssm_state")),
        "w_dt": P((L, d, h), ("layers", "embed", "ssm_heads")),
        "dt_bias": P((L, h), ("layers", "ssm_heads"), "zeros"),
        "a_log": P((L, h), ("layers", "ssm_heads"), "zeros"),
        "d_skip": P((L, h), ("layers", "ssm_heads"), "ones"),
        "conv_x": P((L, cw, d_in), ("layers", "conv_width", "ssm_inner"),
                    scale=0.5),
        "ln_y": P((L, d_in), ("layers", "ssm_inner"), "ones"),
        "w_out": P((L, d_in, d), ("layers", "ssm_inner", "embed")),
    }


def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "embed", scale=0.02),
        "lm_head": P((d, cfg.vocab_size), ("embed", "vocab")),
        "ln_f": P((d,), ("embed",), "ones"),
        "layers": mamba2_layer_specs(cfg),
    }


def init_mamba2(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32, device="cuda"):
    return init_params(generator, mamba2_specs(cfg), dtype, device)


def mamba2_axes(cfg: ArchConfig):
    return param_axes(mamba2_specs(cfg))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in the operands' type.  x [B, L, D], w [CW, D]."""
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


def ssd_scan(x, dt, a, b, c, chunk: int):
    """Chunked SSD.  x [B,L,H,P]; dt [B,L,H]; a [H] (negative);
    b, c [B,L,N] (single group).  Returns y [B,L,H,P], final state [B,H,P,N].

    Each einsum of the JAX package is a pairwise contraction here: ``dt``
    is folded into the decay-weighted scores, then one batched matmul over
    (batch, head) sums over the chunk's steps.
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # dt=0 on padded steps -> decay exp(0)=1, zero input: state unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, l + pad, q):
        xc, dtc = x[:, c0:c0 + q], dt[:, c0:c0 + q]   # [B,q,h,p], [B,q,h]
        bc, cc = b[:, c0:c0 + q], c[:, c0:c0 + q]     # [B,q,n]
        cum = torch.cumsum(dtc * a, dim=1)            # [B,q,h] (negative)
        # intra-chunk: y[l] += sum_{s<=l} C[l]·B[s] exp(cum[l]-cum[s]) dt[s] x[s]
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # [B,q,q,h]
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        scores = cc @ bc.transpose(1, 2)                     # [B,q,q]
        w = scores[:, :, :, None] * decay * dtc[:, None]     # [B,l,s,h]
        y = w.permute(0, 3, 1, 2) @ xc.permute(0, 2, 1, 3)   # [B,h,l,p]
        y = y.permute(0, 2, 1, 3)
        # contribution of the carried-in state
        cs = cc @ state.reshape(bsz, h * p, n).transpose(1, 2)   # [B,q,h*p]
        y = y + cs.reshape(bsz, q, h, p) * torch.exp(cum)[..., None]
        # new state
        dec_out = torch.exp(cum[:, -1:, :] - cum)            # [B,q,h]
        u = (dtc * dec_out)[..., None] * xc                  # [B,q,h,p]
        new_in = u.permute(0, 2, 3, 1).reshape(bsz, h * p, q) @ bc
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + new_in.reshape(bsz, h, p, n))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :l], state


def mamba2_block(x: torch.Tensor, lp: dict, cfg: ArchConfig):
    """One Mamba2 block (full sequence).  x [B, L, d].  Returns the new
    ``x`` and the block's final SSM state [B, H, P, N] (float32)."""
    d_in, h, n, p = _dims(cfg)
    hidden = rms_norm(x, lp["ln"], cfg.norm_eps)
    z = hidden @ lp["w_z"]
    xin = silu(_causal_conv(hidden @ lp["w_x"], lp["conv_x"]))
    bmat = hidden @ lp["w_b"]
    cmat = hidden @ lp["w_c"]
    dt = softplus(hidden @ lp["w_dt"] + lp["dt_bias"])
    a = -torch.exp(lp["a_log"].float())
    xh = xin.reshape(*xin.shape[:2], h, p)
    y, state = ssd_scan(xh.float(), dt.float(), a, bmat.float(),
                        cmat.float(), cfg.ssm_chunk)
    y = y + lp["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(*xin.shape[:2], d_in).to(x.dtype)
    return x + _gated_norm(y, z, lp, cfg) @ lp["w_out"], state


def _gated_norm(y: torch.Tensor, z: torch.Tensor, lp: dict,
                cfg: ArchConfig) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` in ``y``'s type, the gated product kept in
    float32 on its way into the norm: the JAX package's compiled layer
    loop fuses the bf16 product into the norm's float32 convert and never
    rounds it (eagerly it would)."""
    return rms_norm(y.float() * silu(z).float(), lp["ln_y"],
                    cfg.norm_eps).to(y.dtype)


def _embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor):
    """The embedding rows cast to bf16, then scaled by sqrt(d_model)
    rounded to bf16, as the JAX package's weak-typed constant is."""
    return embed_rows(params["embed"], tokens).to(torch.bfloat16) * \
        weak_const(math.sqrt(cfg.d_model), torch.bfloat16)


def mamba2_logits(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """Full-sequence forward; with ``remat`` (and grad on) each block is
    rematerialised, as the JAX package's ``jax.checkpoint(body)``."""
    x = _embed(params, cfg, tokens)

    def body(xx, lp):
        return mamba2_block(xx, lp, cfg)[0]

    for lp in layer_list(bf16_layers(params["layers"])):
        x = checkpointed(body, x, lp, enabled=remat)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(torch.bfloat16)


def mamba2_loss(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    toks = batch["tokens"]
    logits = mamba2_logits(params, cfg, toks[:, :-1])
    return cross_entropy(logits, toks[:, 1:])


# ------------------------------------------------------------------ decode

def mamba2_cache_spec(cfg: ArchConfig, batch: int,
                      n_layers: int | None = None):
    """The SSM and conv states as meta tensors, and their logical axes."""
    d_in, h, n, p = _dims(cfg)
    L = cfg.n_layers if n_layers is None else n_layers
    cw = cfg.ssm_conv_width
    return ({"ssm": torch.empty((L, batch, h, p, n), dtype=torch.float32,
                                device="meta"),
             "conv": torch.empty((L, batch, cw - 1, d_in),
                                 dtype=torch.bfloat16, device="meta")},
            {"ssm": ("layers", "cache_batch", "act_ssm_heads",
                     "act_head_dim", "act_ssm_state"),
             "conv": ("layers", "cache_batch", "conv_width",
                      "act_ssm_inner")})


def init_mamba2_cache(cfg: ArchConfig, batch: int, n_layers=None,
                      device="cuda"):
    spec, _ = mamba2_cache_spec(cfg, batch, n_layers)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def mamba2_block_decode(x: torch.Tensor, lp: dict, cfg: ArchConfig,
                        ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token step.  x [B, d]; ssm_state [B,h,p,n]; conv_state
    [B,cw-1,d_in].  Both states are updated in place; returns the new
    ``x``."""
    d_in, h, n, p = _dims(cfg)
    hidden = rms_norm(x, lp["ln"], cfg.norm_eps)
    z = hidden @ lp["w_z"]
    xin = hidden @ lp["w_x"]
    # conv over [state ; xin]
    window = torch.cat([conv_state, xin[:, None]], dim=1)     # [B,cw,d_in]
    conv_out = (window.float() * lp["conv_x"].float()).sum(dim=1)
    xc = silu(conv_out).to(x.dtype)
    conv_state.copy_(window[:, 1:])
    # B and C enter the float32 recurrence unrounded: the JAX package's
    # compiled step fuses the bf16 projection into its float32 convert
    bvec = hidden.float() @ lp["w_b"].float()
    cvec = hidden.float() @ lp["w_c"].float()
    dt = softplus(hidden @ lp["w_dt"] + lp["dt_bias"]).float()
    a = -torch.exp(lp["a_log"].float())
    xh = xc.reshape(-1, h, p).float()
    decay = torch.exp(dt * a)                                  # [B,h]
    ssm_state.mul_(decay[:, :, None, None]).add_(
        (dt[:, :, None] * xh)[..., None] * bvec[:, None, None, :])
    y = (ssm_state.reshape(-1, h * p, n) @ cvec[:, :, None]).reshape(-1, h, p)
    y = y + lp["d_skip"][None, :, None] * xh
    y = y.reshape(-1, d_in).to(x.dtype)
    return x + _gated_norm(y, z, lp, cfg) @ lp["w_out"]


def mamba2_decode_step(params: dict, cfg: ArchConfig, cache: dict,
                       tokens: torch.Tensor, pos=None):
    """One decode step.  tokens [B] int; ``pos`` is not read (the state
    carries the position).  Returns (logits [B, V], cache), the cache's
    states written in place."""
    x = _embed(params, cfg, tokens)
    layers = bf16_layers(params["layers"])
    for i in range(cfg.n_layers):
        x = mamba2_block_decode(x, _layer(layers, i), cfg, cache["ssm"][i],
                                cache["conv"][i])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"].to(torch.bfloat16), cache


def mamba2_reference_scan(x, dt, a, b, c):
    """O(L) step-by-step SSD oracle (tests): returns y, final state."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        xt, dtt, bt, ct = x[:, t], dt[:, t], b[:, t], c[:, t]
        decay = torch.exp(dtt * a)                           # [B,h]
        state = (state * decay[:, :, None, None]
                 + (dtt[:, :, None] * xt)[..., None] * bt[:, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", ct, state))
    return torch.stack(ys, dim=1), state
