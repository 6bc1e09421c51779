"""Shared model layers and the parameter-spec system, in PyTorch.

Parameters are nested dicts of tensors; every parameter is declared through
a :class:`P` spec carrying its *logical axis names*, so initialisation and
the sharding annotations of a later mesh can never drift apart.

Logical axis vocabulary (weights):
  layers      — stacked layer dim (the layer loop walks it; never sharded)
  embed       — model width on weights
  heads/kv_heads — attention heads
  head_dim    — per-head width
  mlp         — FFN hidden
  vocab       — embedding rows / logits
  experts     — MoE expert dim
  expert_mlp  — per-expert FFN hidden

The numerics follow the JAX package's layers cast for cast: norms and RoPE
in float32 cast back to the input's type; attention products on bf16
operands accumulated (and kept) in float32, probabilities cast to V's type
before the PV product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import resolve_device


# ---------------------------------------------------------------- param specs

@dataclasses.dataclass(frozen=True)
class P:
    """Param spec: shape + logical axes + init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # stddev override
    mean: float = 0.0             # a normal leaf's mean (norm weights near 1)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def init_std(spec: P) -> float:
    """The standard deviation of a ``normal`` / ``embed`` leaf: the spec's
    scale, 1 for an embedding, else 1/sqrt(fan-in), where a stacked-layer
    weight's leading ``layers`` dim is not fan-in."""
    if spec.scale is not None:
        return spec.scale
    if spec.init == "embed":
        return 1.0
    fan_in = spec.shape[0] if len(spec.shape) == 1 else math.prod(
        spec.shape[:-1])
    if len(spec.axes) >= 2 and spec.axes[0] == "layers":
        fan_in = math.prod(spec.shape[1:-1]) or spec.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_params(generator: torch.Generator, specs: Any,
                dtype=torch.float32, device="cuda"):
    """Materialise a tree of :class:`P` specs into tensors on ``device``.
    Leaves are drawn one after another from ``generator``, in sorted-key
    order, on the generator's own device, in ``dtype``; the same generator
    state gives the same weights on the CPU and, copied over, on the card."""
    dev = resolve_device(device)
    out = []
    for spec in tree_leaves(specs):
        if spec.init == "zeros":
            a = torch.zeros(spec.shape, dtype=dtype, device=dev)
        elif spec.init == "ones":
            a = torch.ones(spec.shape, dtype=dtype, device=dev)
        else:
            a = init_std(spec) * torch.randn(
                spec.shape, generator=generator, dtype=dtype,
                device=generator.device)
            if spec.mean:
                a = a + spec.mean
            a = a.to(dev)
        out.append(a)
    return tree_unflatten(specs, out)


def param_axes(specs: Any):
    """Same tree, leaves replaced by the logical-axes tuples."""
    return tree_map(lambda s: s.axes, specs)


def abstract_params(specs: Any, dtype=torch.float32):
    """The tree as meta tensors: shapes and dtypes, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


# ---------------------------------------------------------------- primitives

def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)``, rematerialised where ``enabled`` and grad is on: the
    backward keeps only ``args`` and recomputes ``fn``'s activations from
    them (``torch.utils.checkpoint``, non-reentrant, so weights ``fn``
    reaches through a dict or a closure get their gradients too), as
    ``jax.checkpoint`` does.  The recomputation runs under the sharding
    rules active at the call: on the card autograd runs the backward on a
    thread of its own, where the caller's thread-local rules (and with
    them the meshed MoE branch) would be missing.  The values are those
    of the plain call; under ``no_grad`` (serving, decode) it is the plain
    call."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    from repro_torch.parallel.sharding import activate, current_rules
    rules = current_rules()

    def contexts():
        return (contextlib.nullcontext(),
                contextlib.nullcontext() if rules is None
                else activate(rules.mesh, rules.rules))

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


def layer_list(layers: dict) -> list[dict]:
    """A stacked ``[L, ...]`` weight tree as L per-layer dicts of views,
    one ``unbind`` a leaf: the backward stacks a leaf's L gradients once,
    where L indexed views would each scatter theirs into a zero tensor of
    the whole stack."""
    keys = list(layers)
    return [dict(zip(keys, views))
            for views in zip(*(layers[k].unbind(0) for k in keys))]


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` [V, d] at ``tokens`` (``F.embedding``): the
    values of ``table[tokens]``, whose backward (``index_put_`` with
    accumulation) sums a repeated token's gradients in a different order
    from run to run on the CPU; the embedding's sums in a fixed order, so a
    training run repeats bit for bit."""
    return F.embedding(tokens.long(), table)


def bf16_layers(tree):
    """Cast a stacked-layer param tree's floating leaves to bf16 once per
    call, before the layer loop, so each weight converts once and not once
    per use (a no-op on weights already in bf16)."""
    return tree_map(lambda a: a.to(torch.bfloat16)
                    if a.is_floating_point() else a, tree)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.float()).to(dtype)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """RoPE.  x: [..., S, H, D] (D even); positions: [..., S] int."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # [..., S, half]
    ang = ang[..., None, :]                                     # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def weak_const(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` as the JAX package applies it to an array
    of ``dtype``: JAX's weak typing rounds it to that type first (a
    product of a bf16 array and ``sqrt(2560)`` multiplies by 50.5)."""
    return float(torch.tensor(c, dtype=dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as ``jax.nn.silu`` computes it: the sigmoid as
    ``1 / (1 + exp(-x))``, each step rounded in ``x``'s type (in bf16,
    ``F.silu`` rounds once and differs in 40 % of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` (``logaddexp(x, 0)``)
    computes it: ``max(x, 0) + log1p(exp(-|x|))``, each step rounded in
    ``x``'s type."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU as ``jax.nn.gelu`` (its default)
    computes it: each step rounded in ``x``'s type, its two constants
    rounded to that type first."""
    c = weak_const(math.sqrt(2 / math.pi), x.dtype)
    k = weak_const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: down( silu(x@gate) * (x@up) )."""
    g = silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def geglu(gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The exact-GELU gated MLP's second half: ``gate_up`` [..., 2F] is
    ``[g | u]``; returns ``(gelu(g) * u) @ w_down``, the gate's erf GELU
    and the product in float32, rounded to ``gate_up``'s type once."""
    g, u = gate_up.float().chunk(2, dim=-1)
    return (F.gelu(g) * u).to(gate_up.dtype) @ w_down


# ------------------------------------------------------- chunked flash attn

def _attn_chunk(q, k, v, qpos, kpos, kvalid, window: int | None,
                causal: bool, softmax_scale: float):
    """One (q-chunk x kv-chunk) tile of online-softmax attention.

    q: [B, Qc, KH, G, D]; k, v: [B, Kc, KH, D]; ``kvalid`` [Kc] is False on
    the keys that pad the last chunk; returns (m, l, o) partials.
    QK^T and PV take their operands in the storage type and accumulate in
    float32: a product of two bf16 values is exact in float32, so the
    operands are widened and multiplied in float32, and the result is not
    rounded back.
    """
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float(),
                     k.float()) * softmax_scale
    mask = kvalid[None, :].expand(q.shape[1], -1).clone()
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    mask = mask[None, :, None, None, :]
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1)                                        # [B,Qc,KH,G]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _tile_masked(q0: int, q1: int, k0: int, k1: int, causal: bool,
                 window: int | None) -> bool:
    """Whether every (q, k) of the tile with positions q in [q0, q1) and k in
    [k0, k1) is masked out."""
    if causal and k0 > q1 - 1:
        return True
    return window is not None and q0 - (k1 - 1) >= window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, window: int | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Memory-bounded attention with GQA.

    q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; H % KH == 0.
    Loops over q chunks with an inner loop over kv chunks, carrying the
    online-softmax (max, sum, output) in float32 — the peak live buffer is
    O(q_chunk * kv_chunk), never S^2.  ``q_offset``: absolute position of
    q[0].  A tile whose every (q, k) pair is masked (above the causal
    diagonal, or wholly outside the window) is skipped: it would leave the
    carry exactly as it is (scale 1 on the old terms, 0 on the tile's).
    The zero keys that pad the last kv chunk are masked in every call; the
    JAX package's version masks them only through the causal test, so its
    non-causal calls with ``Sk`` not a multiple of ``kv_chunk`` count them.
    With grad on, each q chunk's kv loop is rematerialised
    (:func:`checkpointed`, the JAX package's ``jax.checkpoint(one_q_chunk)``):
    the backward keeps the chunk's inputs, not its float32 score tiles.
    ``scale`` multiplies the scores (default ``1 / sqrt(D)``).
    """
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    g = h // kh
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq, nk = -(-sq // q_chunk), -(-sk // kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - sk))
    qp = qp.reshape(b, nq, q_chunk, kh, g, d)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(kv_chunk, device=q.device)

    def one_q_chunk(qc, kp, vp, q0: int):
        qpos = q0 + ar_q
        m = torch.full((b, q_chunk, kh, g), -math.inf, device=q.device)
        l = torch.zeros((b, q_chunk, kh, g), device=q.device)
        o = torch.zeros((b, q_chunk, kh, g, d), device=q.device)
        for ki in range(nk):
            k0 = ki * kv_chunk
            if _tile_masked(q0, q0 + q_chunk, k0,
                            min(k0 + kv_chunk, sk), causal, window):
                continue
            kpos = k0 + ar_k
            sl = slice(k0, k0 + kv_chunk)
            mi, li, oi = _attn_chunk(qc, kp[:, sl], vp[:, sl], qpos, kpos,
                                     kpos < sk, window, causal, scale)
            m_new = torch.maximum(m, mi)
            m_new_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            a = torch.exp(m - m_new_safe)
            bcoef = torch.exp(mi - m_new_safe)
            l = a * l + bcoef * li
            o = a[..., None] * o + bcoef[..., None] * oi
            m = m_new
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    outs = [checkpointed(one_q_chunk, qp[:, qi], kp, vp,
                         q_offset + qi * q_chunk) for qi in range(nq)]
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, d)
    return out[:, :sq]


def naive_attention(q, k, v, *, causal=True, window=None, q_offset: int = 0):
    """O(S^2) oracle for flash_attention (tests only)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    qr = q.reshape(b, sq, kh, g, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v).reshape(b, sq, h, d)


CE_CHUNK_ELEMS = 2 ** 27     # float32 elements of a backward chunk (512 MB)


class _CrossEntropy(torch.autograd.Function):
    """``mean(logsumexp(l) - l[target])`` over float32 logits ``l``, whose
    backward keeps the logits in their own type (bf16: half the bytes of
    the float32 copy autograd would keep) and writes their gradient a
    chunk of rows at a time, with autograd's arithmetic for the plain
    expression: ``(g / n) * exp(l - logz)``, ``- g / n`` added at the
    target, rounded to the logits' type.  At a full-width vocabulary the
    plain expression's backward holds several float32 copies of
    ``[tokens, V]`` (6 GB each at 16384 x 92544) at once."""

    @staticmethod
    def forward(ctx, logits, targets):
        idx = targets.long()[..., None]
        lf = logits.float()
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, idx)[..., 0]
        ctx.save_for_backward(logits, logz, idx)
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx = ctx.saved_tensors
        v = logits.shape[-1]
        gn = (g.expand(logz.shape) / logz.numel()).reshape(-1, 1)
        rows, logz, idx = logits.reshape(-1, v), logz.reshape(-1, 1), \
            idx.reshape(-1, 1)
        out = torch.empty_like(rows)
        step = max(1, CE_CHUNK_ELEMS // v)
        for r in range(0, rows.shape[0], step):
            sl = slice(r, r + step)
            grad = gn[sl] * (rows[sl].float() - logz[sl]).exp()
            out[sl] = grad.scatter_add_(-1, idx[sl], -gn[sl])
        return out.reshape(logits.shape), None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits [..., V], targets [...] int; the
    sum over V in float32 (:class:`_CrossEntropy`)."""
    return _CrossEntropy.apply(logits, targets)
