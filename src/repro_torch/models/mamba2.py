"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch.

The SSD recurrence per head:  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t],
y[t] = C[t]·h[t] + D x[t]: the LIF membrane equation without a firing
threshold, the same leaky-integrator scan as the MENAGE core.

The full-sequence scan lives in :mod:`repro_torch.kernels.ssd_scan`: the
chunked scan as in the JAX package (a Python loop over sequence chunks
carrying the inter-chunk state [B, H, P, N], the intra-chunk work the masked
quadratic-in-Q product, Q = ``ssm_chunk``, as pairwise batched matmuls), with
B and C in groups; these older layouts pass one group.  The published
mixer's scan dispatches to a hand-written CUDA kernel on a card when no
gradient is recorded.  Decode is the O(1) recurrence; it writes the SSM and
conv states into the cache tensors in place (the JAX package returns a new
cache), and the returned cache dict holds the same tensors.

Types sit where the JAX package puts them: the forward's causal conv runs
in bf16 on bf16 weights, the decode step's in float32; the scan and the
``d_skip`` term run in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.common import ArchConfig
from repro_torch.kernels import ssd_scan as grouped_scan
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
    y, state = grouped_scan.ssd_scan_plain(
        xh.float(), dt.float(), a, bmat.float()[:, :, None],
        cmat.float()[:, :, None], lp["d_skip"], cfg.ssm_chunk)  # one group
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


# ------------------------------------------- the published mixer, grouped

def _mixer_dims(cfg):
    """``d_in``, heads, state, head width, groups and the conv's width
    (x, B and C together) of the published mixer."""
    d_in, h, n, p = _dims(cfg)
    g = cfg.ssm_ngroups
    return d_in, h, n, p, g, d_in + 2 * g * n


# the published mixer's leaves used in float32: cast once a forward, over
# the whole stack (:func:`mixer_f32_leaves`), not once a layer
F32_LEAVES = ("ln", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "ln_y")


def mixer_layer_specs(cfg) -> dict:
    """The published Mamba2 mixer (Zamba2-7B's; ``cfg.ssm_ngroups``): one
    input projection to ``[z | x B C | dt]``, a depthwise causal conv with
    its bias over x, B and C together, and the gated norm over groups.
    The norm weights, the conv bias, ``dt_bias``, ``A_log`` and ``D`` are
    drawn around their usual values, none 0 or 1, so that leaving any out
    changes the output."""
    d = cfg.d_model
    d_in, h, _, _, _, conv = _mixer_dims(cfg)
    L, cw = cfg.n_layers, cfg.ssm_conv_width
    return {
        "ln": P((L, d), ("layers", "embed"), scale=0.1, mean=1.0),
        "w_in": P((L, d, d_in + conv + h), ("layers", "embed", "ssm_inner")),
        "conv_w": P((L, cw, conv), ("layers", "conv_width", "ssm_inner"),
                    scale=0.5),
        "conv_b": P((L, conv), ("layers", "ssm_inner"), scale=0.1),
        "dt_bias": P((L, h), ("layers", "ssm_heads"), scale=1.0, mean=-4.0),
        "a_log": P((L, h), ("layers", "ssm_heads"), scale=0.5, mean=1.0),
        "d_skip": P((L, h), ("layers", "ssm_heads"), scale=0.5, mean=1.0),
        "ln_y": P((L, d_in), ("layers", "ssm_inner"), scale=0.1, mean=1.0),
        "w_out": P((L, d_in, d), ("layers", "ssm_inner", "embed")),
    }


def mixer_f32_leaves(stack: dict) -> dict:
    """The stacked mixer weights with :data:`F32_LEAVES` in float32."""
    return {k: v.float() if k in F32_LEAVES else v for k, v in stack.items()}


def _rms(x: torch.Tensor, w: torch.Tensor | None, eps: float,
         dtype) -> torch.Tensor:
    """RMSNorm over the last dim in float32 (``F.rms_norm``), in ``dtype``."""
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps).to(dtype)


def _conv_taps(xp: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv of a whole sequence, with its bias and
    SiLU, in float32: ``silu(sum_i xp[:, t + i] * w[i] + bias)`` for each
    of the L positions of ``xp`` [B, CW-1+L, D] (the inputs after CW - 1
    earlier ones); w [CW, D]; bias [D]."""
    cw, l = w.shape[0], xp.shape[1] - w.shape[0] + 1
    out = xp[:, :l] * w[0]
    for i in range(1, cw):
        out.addcmul_(xp[:, i:i + l], w[i])
    return F.silu(out.add_(bias))


def _gated_group_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      groups: int, eps: float) -> torch.Tensor:
    """``RMSNorm(y * silu(z))`` over each of ``groups`` equal slices of the
    last dim, times ``w``, in float32, rounded to ``z``'s type once."""
    v = y * F.silu(z.float())
    v = F.rms_norm(v.view(*v.shape[:-1], groups, -1), (v.shape[-1] // groups,),
                   None, eps)
    return (v.view(y.shape) * w).to(z.dtype)


def mixer_block(h_in: torch.Tensor, lp: dict, cfg):
    """The published mixer over a full sequence (``lp`` with
    :data:`F32_LEAVES` in float32).  ``h_in`` [B, L, d] is the mixer's
    input before its norm.  Returns its update of the residual stream
    [B, L, d], its final SSM state [B, H, P, N] (float32) and its conv
    tail, the last ``CW - 1`` conv inputs [B, CW-1, conv] (zeros before the
    first), so that decoding on from the cache continues this forward as
    the full forward would."""
    d_in, h, n, p, g, conv = _mixer_dims(cfg)
    b, l, _ = h_in.shape
    cw = cfg.ssm_conv_width
    proj = _rms(h_in, lp["ln"], cfg.norm_eps, h_in.dtype) @ lp["w_in"]
    z, xbc, dt = proj.split([d_in, conv, h], dim=-1)
    xp = F.pad(xbc, (0, 0, cw - 1, 0))                   # [B, CW-1+L, conv]
    tail = xp[:, l:]
    xbc = _conv_taps(xp.float(), lp["conv_w"], lp["conv_b"])
    x, bm, cm = xbc.split([d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"])          # [B, L, H]
    y, state = grouped_scan.ssd_scan(
        x.view(b, l, h, p), dt, -torch.exp(lp["a_log"]), bm.view(b, l, g, n),
        cm.view(b, l, g, n), lp["d_skip"], cfg.ssm_chunk)  # y [B, L, H, P]
    y = _gated_group_norm(y.reshape(b, l, d_in), z, lp["ln_y"], g,
                          cfg.norm_eps)
    return y @ lp["w_out"], state, tail


def mixer_block_decode(h_in: torch.Tensor, lp: dict, cfg,
                       ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token through the published mixer (``lp`` as in
    :func:`mixer_block`).  h_in [B, d]; ssm_state [B, H, P, N] and
    conv_state [B, CW-1, conv], both updated in place.  Returns the
    mixer's update [B, d]."""
    d_in, h, n, p, g, conv = _mixer_dims(cfg)
    b, hg = h_in.shape[0], h // g
    proj = _rms(h_in, lp["ln"], cfg.norm_eps, h_in.dtype) @ lp["w_in"]
    z, xbc, dt = proj.split([d_in, conv, h], dim=-1)
    window = torch.cat([conv_state, xbc[:, None]], dim=1)   # [B, CW, conv]
    conv_state.copy_(window[:, 1:])
    xbc = F.silu(torch.sum(window.float() * lp["conv_w"], dim=1)
                 + lp["conv_b"])
    x, bm, cm = xbc.split([d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"])             # [B, H]
    xh = x.reshape(b, h, p)
    sv = ssm_state.view(b, g, hg, p, n)
    sv.mul_(torch.exp(dt * -torch.exp(lp["a_log"])).view(b, g, hg, 1, 1))
    sv.addcmul_((dt[..., None] * xh).view(b, g, hg, p, 1),
                bm.view(b, g, 1, 1, n))
    y = (sv.view(b, g, hg * p, n) @ cm.view(b, g, n, 1)).view(b, h, p)
    y = (y + lp["d_skip"][:, None] * xh).view(b, d_in)
    return _gated_group_norm(y, z, lp["ln_y"], g, cfg.norm_eps) @ lp["w_out"]


def mixer_cache_spec(cfg, batch: int, dtype=torch.bfloat16):
    """The published mixer's SSM states (float32) and conv tails (the
    conv inputs', ``dtype``) as meta tensors, and their logical axes."""
    _, h, n, p, _, conv = _mixer_dims(cfg)
    L, cw = cfg.n_layers, cfg.ssm_conv_width
    return ({"ssm": torch.empty((L, batch, h, p, n), dtype=torch.float32,
                                device="meta"),
             "conv": torch.empty((L, batch, cw - 1, conv), dtype=dtype,
                                 device="meta")},
            {"ssm": ("layers", "cache_batch", "act_ssm_heads",
                     "act_head_dim", "act_ssm_state"),
             "conv": ("layers", "cache_batch", "conv_width",
                      "act_ssm_inner")})
