"""Sequence-parallel flash-decoding, as in the JAX package.

The baseline decode replicates the KV cache over the ``model`` axis
whenever the kv-head count does not divide it.  This module shards the
cache's **sequence** axis over ``model`` instead and computes attention as
a two-pass online softmax (flash-decoding), in two phases over the shards
(:mod:`repro_torch.parallel.mesh`):

  phase 1 (local):  s_i = masked scores, m_i = max over the local seq shard
  fold:             m = pmax(m_i)
  phase 2 (local):  p = exp(s_i - m), l_i = sum p, o_i = p @ v (rounded to
                    the query's type, then widened)
  fold:             l = psum(l_i), o = psum(o_i); out = o / l

It works for any kv-head count and cuts the cache each shard reads by the
model-axis size.  The new token's K/V is written only by the shard that
owns its slot (:func:`sp_cache_update`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import device_guard
from repro_torch.models.layers import weak_const
from repro_torch.parallel.mesh import (Mesh, body_runs, fold_max, fold_sum,
                                      report, shard_copy, split_axes)


def _sp_scores(q, ck, slot_pos, pos, window):
    """Phase 1 of a shard: the float32 scores [b, kh, g, c_loc] over its
    seq shard, ``-inf`` where a slot is invalid, their max, and the mask."""
    b, h, hd = q.shape
    kh = ck.shape[1]
    qr = q.reshape(b, kh, h // kh, hd)
    s = torch.einsum("bhgd,bhcd->bhgc", qr, ck.to(qr.dtype)) / weak_const(
        math.sqrt(hd), qr.dtype)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= (pos - slot_pos) < window
    s = s.float().masked_fill(~valid[None, None, None, :], -math.inf)
    return s, s.amax(dim=-1), valid


def _sp_partials(s, m, valid, cv, dtype):
    """Phase 2 of a shard: its softmax sum and its output, against the
    mesh-wide max ``m`` (0 where every slot is masked)."""
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = p.masked_fill(~valid[None, None, None, :], 0.0)
    o = torch.einsum("bhgc,bhcd->bhgd", p.to(dtype), cv.to(dtype)).float()
    return p.sum(dim=-1), o


def make_sp_attention(mesh: Mesh, axis: str = "model",
                      batch_axes=("pod", "data")):
    """An ``attn_impl`` for ``transformer_decode_step``: the cache's seq
    dim split over ``axis``, the batch over ``batch_axes`` when it divides
    them.  Same signature as ``transformer.decode_attention(q, ck, cv,
    slot_pos, pos, window)``; a cache whose length the axis does not divide
    falls back to it."""
    n_seq = mesh.shape[axis]

    def attn(q, ck, cv, slot_pos, pos, window):
        c = ck.shape[2]
        if c % n_seq != 0:
            from repro_torch.models.transformer import decode_attention
            return decode_attention(q, ck, cv, slot_pos, pos, window)
        b_axes = split_axes(mesh, q.shape[0], batch_axes)
        n_b = math.prod(mesh.shape[a] for a in b_axes)
        bsz, c_loc = q.shape[0] // n_b, c // n_seq

        def local(shard):
            """Shard ``shard``'s batch and seq slices."""
            i = mesh.axis_index(shard, b_axes)
            j = mesh.axis_index(shard, axis)
            return (slice(i * bsz, (i + 1) * bsz),
                    slice(j * c_loc, (j + 1) * c_loc))

        # phase 1: scores and local max
        st = {}
        for shard, dev in enumerate(mesh.devices):
            bs, cs = local(shard)
            with device_guard(dev):
                st[shard] = _sp_scores(
                    shard_copy(q[bs], dev, 0, shard),
                    shard_copy(ck[bs, :, cs], dev, 0, shard),
                    shard_copy(slot_pos[cs], dev, 0, shard),
                    shard_copy(pos, dev, 0, shard)
                    if torch.is_tensor(pos) else pos, window)
            body_runs["sp_attention"] += 1
        groups = mesh.groups(axis)
        m = {}
        for group in groups:
            devs = [mesh.devices[i] for i in group]
            m.update(zip(group, fold_max([st[i][1] for i in group], devs)))
        # phase 2: partial sums against the global max
        part = {}
        for shard, dev in enumerate(mesh.devices):
            bs, cs = local(shard)
            s, _, valid = st[shard]
            with device_guard(dev):
                part[shard] = _sp_partials(
                    s, m[shard], valid,
                    shard_copy(cv[bs, :, cs], dev, 0, shard), q.dtype)
        outs = {}
        for group in groups:
            bi = mesh.axis_index(group[0], b_axes)
            if bi in outs:
                continue
            devs = [mesh.devices[i] for i in group]
            with device_guard(devs[0]):
                l = fold_sum([part[i][0] for i in group], devs)[0]
                o = fold_sum([part[i][1] for i in group], devs)[0]
                out = o / torch.clamp(l, min=1e-30)[..., None]
            outs[bi] = group[0], out.reshape(bsz, *q.shape[1:]).to(q.dtype)
        return torch.cat([shard_copy(outs[i][1], q.device, outs[i][0], 0)
                          for i in range(n_b)])

    return attn


def sp_cache_update(ck, cv, k_new, v_new, slot, mesh: Mesh,
                    axis: str = "model", batch_axes=("pod", "data")):
    """Write the new token's K/V ``[B, KH, hd]`` at ``slot`` (an int or a
    0-d integer tensor) of the seq-sharded caches ``ck``/``cv`` ``[B, KH,
    C, hd]``: only the shard that owns the slot writes, and a slot outside
    every shard writes nothing.  Writes in place (a shard on another device
    copies its block back) and returns ``(ck, cv)``; reads nothing back."""
    b_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    n_b = math.prod(mesh.shape[a] for a in b_axes)
    n_seq = mesh.shape[axis]
    if ck.shape[0] % n_b or ck.shape[2] % n_seq:
        raise ValueError(f"a cache {tuple(ck.shape)} does not split over "
                         f"{n_b} batch and {n_seq} seq shards")
    bsz, c_loc = ck.shape[0] // n_b, ck.shape[2] // n_seq
    for shard, dev in enumerate(mesh.devices):
        bi = mesh.axis_index(shard, b_axes)
        j = mesh.axis_index(shard, axis)
        bs = slice(bi * bsz, (bi + 1) * bsz)
        cs = slice(j * c_loc, (j + 1) * c_loc)
        with device_guard(dev):
            local = (shard_copy(slot, dev, 0, shard) if torch.is_tensor(slot)
                     else torch.full((), slot, dtype=torch.int64,
                                     device=dev)) - j * c_loc
            in_range = (local >= 0) & (local < c_loc)
            safe = torch.clamp(local, 0, c_loc - 1).reshape(1)
            for cache, new in ((ck, k_new), (cv, v_new)):
                home = cache[bs, :, cs]
                blk = shard_copy(home, dev, 0, shard)
                cur = blk.index_select(2, safe)[:, :, 0]
                upd = torch.where(in_range,
                                  shard_copy(new[bs], dev, 0, shard,
                                             blk.dtype), cur)
                blk.index_copy_(2, safe, upd[:, :, None])
                if blk is not home:
                    home.copy_(blk)
                if shard:
                    report("p2p", home.numel() * home.element_size(), 1)
        body_runs["sp_cache_update"] += 1
    return ck, cv
