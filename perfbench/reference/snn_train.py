"""Plain PyTorch reference of surrogate-gradient training of a spiking MLP
(the paper's Algorithm 1, Table I's Adam).

Forward over time: per layer ``v = beta * v + x @ w``, a spike where
``v >= threshold`` (its gradient the fast sigmoid ``slope / (1 + |slope
(v - threshold)|)**2``), a hard reset; the loss is the cross-entropy of
the output spike counts against the labels, averaged over the batch.
Adam with bias correction at a constant rate, the corrections worked out
in float32 from a float32 step count.  Everything in float32 with
TF32 off; ``precision="tf32"`` (the control) lets the products run in
TF32.  Nothing here imports the program.
"""

from __future__ import annotations

import torch


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, threshold: float, slope: float):
        ctx.save_for_backward(v)
        ctx.threshold, ctx.slope = threshold, slope
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        x = ctx.slope * (v - ctx.threshold)
        return g * (1.0 / (1.0 + x.abs()) ** 2) * ctx.slope, None, None


def loss(params, spikes: torch.Tensor, labels: torch.Tensor,
         lif: dict) -> torch.Tensor:
    """Mean cross-entropy of the output spike counts; ``spikes [T, B,
    n_in]``."""
    dev = spikes.device
    beta, reset = (torch.tensor(float(lif[k]), dtype=torch.float32,
                                device=dev) for k in ("beta", "v_reset"))
    vs = [spikes.new_zeros((spikes.shape[1], w.shape[1])) for w in params]
    counts = 0
    for s_t in spikes:
        x = s_t
        for i, w in enumerate(params):
            v = beta * vs[i] + x @ w
            x = _Spike.apply(v, float(lif["threshold"]),
                             float(lif["surrogate_slope"]))
            vs[i] = torch.where(x > 0, reset, v)
        counts = counts + x
    logp = torch.log_softmax(counts, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def train(init, batches, lif: dict, adam: dict,
          precision: str = "float32") -> dict:
    """Adam steps from ``init`` over ``batches`` (``(spikes, labels)``
    pairs).  Returns each step's loss, the first step's gradient and the
    parameters after the last step."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        params = [p.detach().clone() for p in init]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        dev = params[0].device
        b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
        lr = torch.tensor(float(adam["lr"]), dtype=torch.float32, device=dev)
        losses, first = [], None
        for k, (spikes, labels) in enumerate(batches, start=1):
            leaves = [p.requires_grad_(True) for p in params]
            value = loss(leaves, spikes, labels, lif)
            grads = torch.autograd.grad(value, leaves)
            losses.append(float(value.detach()))
            if first is None:
                first = [g.detach().clone() for g in grads]
            with torch.no_grad():
                # the bias corrections in float32, as the step counter is
                t = torch.tensor(float(k), dtype=torch.float32, device=dev)
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                nxt = []
                for i, (p, g) in enumerate(zip(params, grads)):
                    m[i] = b1 * m[i] + (1 - b1) * g
                    v[i] = b2 * v[i] + (1 - b2) * g * g
                    step = (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps)
                    nxt.append(p - lr * step)
            params = nxt
        return dict(losses=losses, first_grad=first,
                    params=[p.detach() for p in params])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
