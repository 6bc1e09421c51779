"""The system under test for a spiking-MLP configuration: seeded weights
made on the device, mapped onto the configured accelerator and packed by
the program, and the request pool the traffic draws from.

Set-up order, fixed so that one seed always gives the same inputs: one
``torch.Generator`` on the device, seeded with ``--seed``, draws every
layer's weights and then the pool's frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.traffic.dvs import draw_pool


def seeded_weights(cfg: dict, gen: torch.Generator, device) -> list:
    """N(0, 1/n_in) weights, the smaller-magnitude ``prune_fraction`` of
    each layer set to 0, times the configuration's gain (``chip_smoke.py``'s
    ``pruned_mlp``, with the gain fixed so that every layer fires)."""
    sizes, gain = cfg["layer_sizes"], float(cfg["gain"])
    ws = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, device=device) / float(np.sqrt(a))
        k = int(w.numel() * cfg["prune_fraction"])
        th = w.abs().flatten().kthvalue(k + 1).values
        ws.append(torch.where(w.abs() < th, 0.0, w) * gain)
    return ws


def build(cfg: dict, gen: torch.Generator, device) -> dict:
    """Weights, then ``map_model`` and ``pack`` timed on the host clock."""
    from repro_torch.core.accelerator import map_model
    from repro_torch.core.energy import AcceleratorSpec
    from repro_torch.core.lif import LIFParams

    ws = seeded_weights(cfg, gen, device)
    host = [w.cpu().numpy() for w in ws]
    spec = AcceleratorSpec(**cfg["accelerator"])
    t0 = time.perf_counter()
    with record_function("map_model"):
        mapped = map_model(host, spec, lif=LIFParams(**cfg["lif"]),
                           quant_bits=list(cfg["quant_bits"]))
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with record_function("pack"):
        packed = mapped.pack(device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    return dict(weights=ws, packed=packed, map_s=map_s, pack_s=pack_s)


def pool(cfg: dict, lengths, gen: torch.Generator, device):
    """The request pool: host streams and their frames on ``device``."""
    return draw_pool(cfg["data"], lengths, gen, device)
