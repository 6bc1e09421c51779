"""Zamba2-7B-Instruct's forward in plain float32 PyTorch: the reference the
port's Zamba2 (published layout) is held to.

The model (hf: Zyphra/Zamba2-7B-Instruct, config.json; ``transformers``'
``modeling_zamba2.py``), at width d, every norm an RMSNorm:

- ``e = embed[tokens]``, not scaled; ``x = e``.
- Layer i (every layer is a Mamba2 mixer): ``h = x + t_i`` where ``t_i``
  is the shared block's output at a hybrid layer (else 0);
  ``x = x + mixer_i(h)``.  The mixer: ``RMSNorm(h) @ W_in`` gives
  ``[z | xBC | dt]``; ``xBC = silu(causal depthwise conv(xBC) + bias)``
  split into x (heads x head width) and B, C (groups x state), head j
  reading group ``j // (H / G)``; ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``; the recurrence ``s = exp(dt A) s + dt x B``,
  ``y = C . s + D x``; ``y = GroupRMSNorm(y * silu(z))`` over G groups;
  the update is ``y @ W_out``.
- Hybrid application k (shared block ``k % n_mem_blocks``):
  ``a = RMSNorm(concat(x, e))``; q, k, v = ``a @ W{q,k,v}``, rotary over the
  whole head (rotate-half); causal softmax attention scaled by
  ``(head_dim / 2) ** -0.5``; ``o = attn @ W_o``; no residual:
  ``m = RMSNorm(o)``; ``g|u = m @ W_gu + (m @ A_k) @ B_k`` (the
  application's LoRA); ``out = (gelu(g) * u) @ W_down`` (exact GELU);
  ``t = out @ L_k`` (the application's linear).
- ``logits = RMSNorm_f(x) @ embed.T`` (tied head).

Nothing here is cached, chunked or batched across positions: the
recurrence runs one position at a time and the attention is the full
masked score matrix.  The weights are a tree in the port's layout (the
data the program serves): ``embed`` [V, d], ``ln_f``; ``mamba`` stacked
over layers (``ln``, ``w_in`` [d, out], ``conv_w`` [CW, conv], ``conv_b``,
``dt_bias``, ``a_log``, ``d_skip``, ``ln_y``, ``w_out``); ``shared``
stacked over blocks (``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``,
``w_gu`` = ``[gate | up]``, ``w_down``); ``apps`` stacked over applications
(``lora_a``, ``lora_b``, ``linear``); every matrix ``[in, out]``.  The
configuration is a dict under the published config's keys.

Departures from the published model, none of which the port makes either:
``dt`` is not clamped below (the published ``time_step_limit`` is null,
as the fused CUDA path reads it; ``transformers``' plain-torch path clamps
it at ``time_step_min``); there is no padding mask (every prompt of a
batch has the same length); rotary's cos and sin stay in float32; the
weights are drawn from a seed, not trained.

``operand`` rounds every operand of a product (activations and weights)
before it is used, e.g. to float8 e4m3 with a per-tensor scale: the
control one precision below bf16.

Imports nothing but ``torch``; a copy lives in ``perfbench/reference/``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def float8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude at the format's largest finite value, 448), in float32."""
    t = t.float()
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, in float32."""
    return {k: v[i].float() for k, v in tree.items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _mm(a: torch.Tensor, w: torch.Tensor, operand) -> torch.Tensor:
    return operand(a) @ operand(w)


def mixer(h: torch.Tensor, lp: dict, cfg: dict,
          operand=_same) -> torch.Tensor:
    """One Mamba2 mixer over a whole sequence: h [B, L, d] its input
    before the norm.  Returns its update of ``x`` [B, L, d]."""
    b, l, _ = h.shape
    d_in = cfg["mamba_expand"] * cfg["hidden_size"]
    nh, p = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    cw = cfg["mamba_d_conv"]
    eps = cfg["rms_norm_eps"]
    proj = _mm(rms_norm(h.float(), lp["ln"], eps), lp["w_in"], operand)
    z, xbc, dt = proj.split([d_in, d_in + 2 * g * n, nh], dim=-1)
    # causal depthwise conv: out[t] = sum_i xbc[t - (CW-1) + i] * w[i]
    xp = F.pad(xbc, (0, 0, cw - 1, 0))
    conv = lp["conv_b"].expand_as(xbc).clone()
    for i in range(cw):
        conv = conv + xp[:, i:i + l] * lp["conv_w"][i]
    xbc = silu(conv)
    x, bm, cm = xbc.split([d_in, g * n, g * n], dim=-1)
    x = x.reshape(b, l, nh, p)
    head_group = torch.arange(nh, device=h.device) // (nh // g)
    bm = bm.reshape(b, l, g, n)[:, :, head_group]           # [B, L, H, N]
    cm = cm.reshape(b, l, g, n)[:, :, head_group]
    dt = F.softplus(dt + lp["dt_bias"])                     # [B, L, H]
    a = -torch.exp(lp["a_log"])
    state = torch.zeros((b, nh, p, n), device=h.device)
    ys = []
    for t in range(l):
        state = (state * torch.exp(dt[:, t] * a)[:, :, None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * bm[:, t, :, None, :])
        ys.append((state * cm[:, t, :, None, :]).sum(-1)
                  + lp["d_skip"][:, None] * x[:, t])
    y = torch.stack(ys, dim=1).reshape(b, l, d_in) * silu(z)
    y = y.reshape(b, l, g, d_in // g)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)
    y = y.reshape(b, l, d_in) * lp["ln_y"]
    return _mm(y, lp["w_out"], operand)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary over the whole head.  x [B, H, S, D]."""
    s, dim = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=x.device).float()
                          / dim)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    rot = torch.cat([-x[..., dim // 2:], x[..., :dim // 2]], dim=-1)
    return x * cos + rot * sin


def shared(x: torch.Tensor, e: torch.Tensor, sp: dict, ap: dict, cfg: dict,
           operand=_same) -> torch.Tensor:
    """One shared-block application over a whole sequence: x, e [B, S, d].
    Returns its output through the application's linear, ``t`` [B, S, d]."""
    b, s, _ = x.shape
    nh, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    eps = cfg["rms_norm_eps"]
    a = rms_norm(torch.cat([x.float(), e.float()], dim=-1), sp["ln1"], eps)
    q, k, v = (_mm(a, sp[w], operand).reshape(b, s, nh, hd).transpose(1, 2)
               for w in ("wq", "wk", "wv"))
    if cfg["use_mem_rope"]:
        q, k = rotary(q, cfg["rope_theta"]), rotary(k, cfg["rope_theta"])
    scores = _mm(q, k.transpose(-1, -2), operand) * (hd / 2) ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    o = _mm(probs, v, operand).transpose(1, 2).reshape(b, s, nh * hd)
    m = rms_norm(_mm(o, sp["wo"], operand), sp["ln2"], eps)
    gu = _mm(m, sp["w_gu"], operand) + _mm(_mm(m, ap["lora_a"], operand),
                                           ap["lora_b"], operand)
    g, u = gu.chunk(2, dim=-1)
    out = _mm(F.gelu(g) * u, sp["w_down"], operand)
    return _mm(out, ap["linear"], operand)


def head(x: torch.Tensor, params: dict, cfg: dict,
         operand=_same) -> torch.Tensor:
    """The tied head on the final hidden state: logits [..., V]."""
    return _mm(rms_norm(x.float(), params["ln_f"].float(),
                        cfg["rms_norm_eps"]), params["embed"].float().T,
               operand)


def forward(tokens: torch.Tensor, params: dict, cfg: dict,
            operand=_same) -> torch.Tensor:
    """Every position's logits [B, S, V] of ``tokens`` [B, S]."""
    e = params["embed"].float()[tokens.long()]
    x = e
    hybrid = list(cfg["hybrid_layer_ids"])
    for i in range(cfg["num_hidden_layers"]):
        h = x
        if i in hybrid:
            k = hybrid.index(i)
            sp = layer(params["shared"], k % cfg["num_mem_blocks"])
            h = x + shared(x, e, sp, layer(params["apps"], k), cfg, operand)
        x = x + mixer(h, layer(params["mamba"], i), cfg, operand)
    return head(x, params, cfg, operand)
