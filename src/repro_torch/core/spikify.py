"""Spikified linear-layer execution: MENAGE's event-driven engine applied to
a conventional dense layer.

Any matmul ``y = x @ W`` with non-negative activations (post-ReLU/GELU-ish)
can be executed MENAGE-style: rate-encode ``x`` into ``T`` Bernoulli spike
frames, push each frame's *events* through the synaptic accumulation
(``ops.event_synapse`` — work ∝ events, not n_src·n_dest), and decode by
averaging.  The estimator is unbiased: E[y_hat] = x_clipped @ W; the error
shrinks as 1/sqrt(T), and with activation sparsity the event path touches
only ``mean_rate`` of the dense weight traffic.

The arithmetic is the reference's, in its rounding order: ``x_max =
max(max(x), 1e-6)`` (kept on the device), ``rates = clip(x / x_max, 0, 1)``,
frame ``t`` = ``uniform < rates``, ``acc = ((0 + cur_0) + cur_1) + ...`` in
frame order, ``y = acc / T * x_max``.  All ``T`` frames go through one
event_synapse launch over ``T * B`` rows (rows are independent, so this
equals a launch per frame bit for bit), then the ``[T, B, n_out]`` currents
are folded over ``T`` one add at a time.  A CUDA input runs the
hand-written kernel, a CPU input its plain version.  The frames come from
an explicit ``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

import torch

from repro_torch.core.lif import rate_encode
from repro_torch.kernels import ops


def _f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: dividing by it is a true
    division on every device (a Python number divisor may become a
    multiply by its reciprocal on the card)."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def rate_scale(x: torch.Tensor, x_max=None):
    """``(rates, x_max)``: ``x_max`` (default ``max(max(x), 1e-6)``, a 0-d
    tensor on ``x``'s device, never read back) and ``clip(x / x_max, 0,
    1)``, the spike probabilities of the frames."""
    if x_max is None:
        x_max = torch.maximum(x.max(), _f32(1e-6, x.device))
    else:
        x_max = _f32(x_max, x.device)
    return torch.clamp(x / x_max, 0.0, 1.0), x_max


def accumulate_frames(frames: torch.Tensor, w: torch.Tensor,
                      max_events: int | None = None):
    """Spike frames ``[T, B, n_in]`` (0/1) through the event path: one
    ``events_from_spikes`` + ``event_synapse`` over all ``T * B`` rows, then
    the per-frame currents summed over ``T`` in frame order.  Returns
    ``(acc [B, n_out], valid events)``, the count a 0-d int64 tensor."""
    t, b, n_in = frames.shape
    ev = ops.events_from_spikes(frames.reshape(t * b, n_in),
                                n_in if max_events is None else max_events)
    cur = ops.event_synapse(ev, w, compacted=True).reshape(t, b, -1)
    acc = torch.zeros(b, w.shape[1], dtype=torch.float32, device=w.device)
    for step in range(t):
        acc = acc + cur[step]
    return acc, (ev >= 0).sum()


def spikified_linear(generator: torch.Generator | None, x: torch.Tensor,
                     w: torch.Tensor, num_steps: int = 32, x_max=None,
                     max_events: int | None = None):
    """x [B, n_in] (>=0), w [n_in, n_out] -> (y_hat [B, n_out], stats).

    Rate-codes x/x_max into ``num_steps`` Bernoulli frames drawn from
    ``generator``, accumulates their events through the event_synapse
    kernel, decodes by averaging.  ``stats``: ``events`` (valid events, a
    0-d int64 tensor), ``dense_equiv_events`` (``T * B * n_in``) and
    ``event_fraction`` (their ratio, a 0-d tensor)."""
    b, n_in = x.shape
    rates, x_max = rate_scale(x, x_max)
    frames = rate_encode(rates, num_steps, generator)
    acc, n_events = accumulate_frames(frames, w, max_events)
    y = acc / _f32(num_steps, acc.device) * x_max
    dense = num_steps * b * n_in
    stats = {"events": n_events, "dense_equiv_events": dense,
             "event_fraction": n_events / dense}
    return y, stats


def spikified_ffn(generator: torch.Generator | None, x: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor,
                  num_steps: int = 32):
    """A spikified 2-layer ReLU FFN: dense-in -> ReLU -> spikified matmul.

    The second matmul consumes the *sparse, non-negative* ReLU activations —
    exactly where event-driven execution pays.  The first is a plain float32
    ``torch.matmul`` with TF32 off, as the reference computes it outside any
    kernel."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h = torch.relu(torch.matmul(x, w_in))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return spikified_linear(generator, h, w_out, num_steps=num_steps)
