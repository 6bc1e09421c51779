"""The meshed MoE: locality-exact expert dispatch over a ``model`` axis, as
the JAX package's ``shard_map`` MoE.

At the FFN input the activations ``x [B, S, d]`` are sharded over the batch
only, so every ``model`` shard holds all of its batch shard's tokens and
runs the whole dispatch locally for its slice of the expert computation:

  * EP mode (``E % model == 0``): a shard owns ``E / model`` experts;
  * TP mode (otherwise): a shard owns every expert's slice of ``d_ff``;

and the only collective is the psum of the down projection's partial sums
over ``model``.  Per-shard capacity replaces the global one: it is rounded
up to a multiple of 128 and capped at the shard's token count, unlike
:func:`~repro_torch.models.transformer.moe_ffn`'s power of two, so a
meshed prefill differs from an unmeshed one.

The body runs in two phases over the mesh's shards
(:mod:`repro_torch.parallel.mesh`): every shard's dispatch, expert products
and combine, then the folds (``y`` over ``model``, the load-balance
estimate over the batch shards).  The expert products are float32 matmuls
of the widened operands (a product of two bf16 values is exact in
float32), with TF32 off on the card in the forward and in the backward
(:func:`exact_matmul`, the router's product too); ``g * u`` is rounded to
``x``'s type before the down projection; each token's k contributions are
added in the order of their sorted pairs (by expert), with no atomics, so
a run on the card repeats bit for bit.  The body is differentiable: the
gradient flows back through each shard's copies, the folds and the
combine, so the meshed MoE trains.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import device_guard, exact_float32
from repro_torch.models.layers import silu
from repro_torch.parallel.mesh import Mesh, body_runs, fold_sum, split_axes


class _ExactMatmul(torch.autograd.Function):
    """``torch.matmul`` of two 2-D or two 3-D tensors whose forward and
    backward both run under :func:`~repro_torch.device.exact_float32` on
    the operands' device."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with exact_float32(a.device):
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with exact_float32(a.device):
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.mT)
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.mT, g)
        return ga, gb


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) rounded as float32 on the card in
    the forward and in the backward alike, whatever the caller's TF32
    setting: autograd runs the backward after the forward's
    ``exact_float32`` block has closed, so the scope travels with the
    product.  Its values are ``torch.matmul``'s; its gradients are the
    products of ``mm``'s and ``bmm``'s own backward."""
    return _ExactMatmul.apply(a, b)


def combine(contrib: torch.Tensor, order: torch.Tensor,
            eff_idx: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its k contributions: ``contrib`` [t*k, d] in
    sorted-pair order (``order`` the sorting permutation of the pairs,
    ``eff_idx`` [t, k] the expert each pair sorted by).  A token's terms
    are added left to right in their sorted order, as the JAX package's
    scatter-add meets them on the CPU, starting from its first term."""
    t, k = eff_idx.shape
    by_pair = torch.empty_like(contrib).index_copy_(0, order, contrib)
    rank = torch.argsort(eff_idx, dim=1, stable=True)
    src = torch.arange(t, device=contrib.device)[:, None] * k + rank
    terms = by_pair[src.reshape(-1)].reshape(t, k, -1)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y


def local_moe(xf: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float, ep_mode: bool,
              shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's body up to the folds: ``xf`` [t, d] its tokens, the
    router replicated, the expert weights its slice (experts in EP mode,
    ``d_ff`` in TP mode), ``shard`` its index on the model axis.  Returns
    its float32 partial ``y`` [t, d] and its load-balance estimate.
    The router's and the experts' products are exact float32 in the
    forward and the backward (:func:`exact_matmul`); on the card, run the
    rest under :func:`~repro_torch.device.exact_float32`."""
    t, d = xf.shape
    e, k = n_experts, top_k
    logits = exact_matmul(xf, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (local estimate; averaged over the batch shards)
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=xf.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=xf.device))
    aux = e * torch.sum(me * ce)

    if ep_mode:
        # keep only pairs routed to this shard's experts; the rest go to
        # drop row e_loc
        e_loc = wg.shape[0]
        lo = shard * e_loc
        local = (expert_idx >= lo) & (expert_idx < lo + e_loc)
        eff_idx = torch.where(local, expert_idx - lo, e_loc)
        n_disp = e_loc
    else:
        eff_idx = expert_idx
        n_disp = e

    # capacity: a multiple of 128, at most the shard's tokens
    cap = int(math.ceil(t * k / n_experts * capacity_factor / 128.0)) * 128
    cap = max(min(cap, t), 1)

    flat_e = eff_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    grp_start = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(t * k, device=xf.device) - grp_start
    keep = (pos_in_e < cap) & (sorted_e < n_disp)
    slot = torch.where(keep, sorted_e * cap + pos_in_e, n_disp * cap)
    token_of = order // k

    # every kept pair has a slot of its own; the dropped ones share the
    # last row, which is cut off
    disp = torch.zeros((n_disp * cap + 1, d), dtype=xf.dtype,
                       device=xf.device).index_copy_(0, slot, xf[token_of])
    disp = disp[:n_disp * cap].reshape(n_disp, cap, d).float()

    g = silu(exact_matmul(disp, wg.float()))
    u = exact_matmul(disp, wu.float())
    out = exact_matmul((g * u).to(xf.dtype).float(), wd.float())
    out = out.reshape(n_disp * cap, d)

    contrib = out[torch.where(keep, slot, 0)] * (
        keep * gate.reshape(-1)[order]).float()[:, None]
    return combine(contrib, order, eff_idx), aux


def moe_ffn_sharded(x: torch.Tensor, lp: dict, cfg, mesh: Mesh,
                    capacity_factor: float = 1.25,
                    model_axis: str = "model",
                    batch_axes: tuple[str, ...] = ("pod", "data")):
    """Drop-in for ``transformer.moe_ffn`` under an active mesh.  x [B,S,d]
    (on the mesh's first device, as the returned ``y`` and ``aux`` are)."""
    b, s, d = x.shape
    e = cfg.n_experts
    if model_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {model_axis!r} axis")
    n_model = mesh.shape[model_axis]
    b_axes = split_axes(mesh, b, batch_axes)
    n_b = math.prod(mesh.shape[a] for a in b_axes)
    bsz = b // n_b
    ep_mode = e % n_model == 0
    if not ep_mode and cfg.d_ff % n_model:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over a "
                         f"{n_model}-way {model_axis!r} axis")
    w = {n: lp[n] for n in ("we_gate", "we_up", "we_down")}

    def weights(m: int, dev) -> list[torch.Tensor]:
        """Shard m's slices of the expert weights, on its device."""
        if ep_mode:
            n = e // n_model
            sl = [w[k][m * n:(m + 1) * n] for k in w]
        else:
            n = cfg.d_ff // n_model
            cut = slice(m * n, (m + 1) * n)
            sl = [w["we_gate"][:, :, cut], w["we_up"][:, :, cut],
                  w["we_down"][:, cut]]
        return [t.to(dev) for t in sl]

    # phase 1: every shard's local MoE
    parts, auxes = {}, {}
    for shard, dev in enumerate(mesh.devices):
        bi = mesh.axis_index(shard, b_axes)
        m = mesh.axis_index(shard, model_axis)
        with device_guard(dev), exact_float32(dev):
            x3 = x[bi * bsz:(bi + 1) * bsz].to(dev)
            parts[shard], auxes[shard] = local_moe(
                x3.reshape(bsz * s, d), lp["router"].to(dev),
                *weights(m, dev), n_experts=e, top_k=cfg.top_k,
                capacity_factor=capacity_factor, ep_mode=ep_mode, shard=m)
        body_runs["moe"] += 1

    # phase 2: psum y over the model axis; pmean aux over the batch shards
    dev0 = mesh.devices[0]
    ys = {}
    for group in mesh.groups(model_axis):
        devs = [mesh.devices[i] for i in group]
        bi = mesh.axis_index(group[0], b_axes)
        if bi not in ys:
            ys[bi] = fold_sum([parts[i] for i in group], devs)[0]
    y = torch.cat([ys[i].to(dev0).to(x.dtype) for i in range(n_b)])
    aux = auxes[0]
    if b_axes:
        group = mesh.groups(b_axes)[0]
        aux = fold_sum([auxes[i] for i in group],
                       [mesh.devices[i] for i in group])[0] / n_b
    return y.reshape(b, s, d), aux.to(dev0)
