"""Plain PyTorch reference of a quantized spiking MLP, as the MENAGE chip
computes it (paper §III, eq. (1)).

It takes the float weights the benchmark hands the program and works the
rest out again: symmetric per-tensor quantization to the layer's bit width
(round half to even, codes clipped to ``[-qmax, qmax]``, a pruned weight
stays 0), each step's synaptic current as the float32 sum of the weight
rows of the inputs that spiked, added in ascending source order and
rounded after every add (the chip's event order), then the LIF cell
``v = beta * v + I`` (each product and sum rounded to float32), a spike
where ``v >= threshold`` and a hard reset.  It also counts what the chip's
dispatch statistics count: the events a layer receives a step, and the
synaptic operations they trigger (each event adds its source's non-zero
weights).

Nothing here imports the program; it runs on any device, TF32 off.
``precision="tf32"`` is the control: the same model with each layer's
currents taken as one TF32 matmul, the precision below the float32 the
configuration states.
"""

from __future__ import annotations

import torch


def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The weights the chip stores, dequantized: ``code * scale`` in
    float32, 0 where ``w`` is 0."""
    qmax = torch.tensor(float(2 ** (bits - 1) - 1), device=w.device)
    # a true division: a tensor over a host number runs on the card as a
    # product with its rounded reciprocal, an ulp off for some weights
    scale = torch.clamp(w.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q * scale * (w != 0)


def ordered_currents(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for 0/1 rows ``x [R, n_src]``, summed source by source in
    ascending order with one float32 rounding per add."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for s in torch.nonzero(x.any(dim=0)).flatten().tolist():
        acc.addcmul_(x[:, s:s + 1], w[s:s + 1])
    return acc


def lif(currents: torch.Tensor, lengths, lif_params: dict) -> torch.Tensor:
    """LIF over each request's steps; ``currents`` holds the requests'
    rows one after another.  Returns the spikes in the same layout."""
    dev = currents.device
    beta, thr, reset = (torch.tensor(float(lif_params[k]), dtype=torch.float32,
                                     device=dev)
                        for k in ("beta", "threshold", "v_reset"))
    lengths = torch.as_tensor([int(t) for t in lengths], device=dev)
    starts = torch.cumsum(lengths, 0) - lengths
    n = currents.shape[1]
    v = torch.zeros((len(lengths), n), dtype=torch.float32, device=dev)
    out = torch.zeros_like(currents)
    for t in range(int(lengths.max())):
        live = torch.nonzero(lengths > t).flatten()
        rows = starts[live] + t
        vt = beta * v[live] + currents[rows]
        s = vt >= thr
        out[rows] = s.to(torch.float32)
        v[live] = torch.where(s, reset, vt)
    return out


def forward(frames: torch.Tensor, lengths, weights, bits, lif_params: dict,
            precision: str = "float32") -> dict:
    """Run requests (``frames [sum T_i, n_in]``, rows of request ``i``
    after those of request ``i - 1``) through the quantized MLP.

    Returns per layer the input spikes (``inputs``), the events a step
    (``events``) and the synaptic operations a step (``ops``), each ``[sum
    T_i]`` int64, and the output spikes (``out``)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        x, inputs, events, ops = frames, [], [], []
        for w, b in zip(weights, bits):
            wq = quantize(w.to(torch.float32), int(b))
            nnz = (wq != 0).sum(dim=1).to(torch.float64)
            inputs.append(x)
            events.append(x.sum(dim=1).to(torch.int64))
            ops.append((x.to(torch.float64) @ nnz).to(torch.int64))
            cur = ordered_currents(x, wq) if precision == "float32" else x @ wq
            x = lif(cur, lengths, lif_params)
        return dict(inputs=inputs, events=events, ops=ops, out=x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
