"""Gradient compression with error feedback (distributed-optimization trick).

int8 block-quantized gradients for a data-parallel all-reduce: 4x less
traffic between devices.  Error feedback (Seide et al.; EF-SGD) accumulates
the quantization residual locally so the compressed update is unbiased over
time — convergence-safe.

Used by :mod:`repro_torch.engine.train_loop` when
``CompressionConfig.enabled``: gradients are compressed, then decompressed
and residual-corrected.  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the block scale divides by a tensor (a true
division on the card as on the CPU), so the codes and scales equal the
reference's eager ones bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.pytree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    block: int = 256          # per-block scale granularity


def _leaf_compress(g: torch.Tensor, block: int):
    flat = g.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = (blocks.abs().amax(dim=1, keepdim=True)
             / blocks.new_full((), 127.0))
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _leaf_decompress(q: torch.Tensor, scale: torch.Tensor, shape, size):
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_gradients(grads, residual, cfg: CompressionConfig):
    """(grads + residual) -> (compressed pytree, new residual).  Each leaf
    of the compressed tree is a ``(q int8 [n_blocks, block], scale float32
    [n_blocks, 1])`` pair."""

    def one(g, r):
        x = g.to(torch.float32) + r
        q, s = _leaf_compress(x, cfg.block)
        approx = _leaf_decompress(q, s, g.shape, g.numel())
        return (q, s), x - approx

    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residual))]
    comp = tree_unflatten(grads, [o[0] for o in outs])
    new_res = tree_unflatten(grads, [o[1] for o in outs])
    return comp, new_res


def decompress_gradients(comp, grads_like):
    """Inverse of :func:`compress_gradients`, cast back to each leaf's
    original dtype — decompression happens in float32 internally, and
    silently widening a bf16 gradient tree would break dtype-strict
    optimizer updates (and double the memory the compression saved)."""
    flat_c = tree_leaves(comp)              # q0, scale0, q1, scale1, ...
    flat_g = tree_leaves(grads_like)
    outs = [_leaf_decompress(q, s, g.shape, g.numel()).to(g.dtype)
            for q, s, g in zip(flat_c[0::2], flat_c[1::2], flat_g)]
    return tree_unflatten(grads_like, outs)


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
