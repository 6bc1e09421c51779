"""DVS-like spike trains: the synthetic CIFAR10-DVS / N-MNIST rate maps and
the Bernoulli draws of a request pool.

Frozen copies of the program's generators, so that a change to the
program cannot change the benchmark's inputs: ``class_rate_maps`` is
``repro_torch.data.events._class_rate_maps`` (same numpy seed, same maps),
and ``draw_pool`` draws each request's frames as ``chip_smoke.py``'s
``rate_map_streams`` does (request ``i`` of class ``i % num_classes``,
each input firing with its class's rate), on the device with a
``torch.Generator`` in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def class_rate_maps(data: dict) -> np.ndarray:
    """Per-class Poisson rate maps ``[C, 2 * H * W]`` (float32)."""
    h, w, c = data["height"], data["width"], data["num_classes"]
    rng = np.random.default_rng(data["rate_map_seed"])
    yy, xx = np.mgrid[0:h, 0:w]
    maps = np.full((c, 2, h, w), data["base_rate"], dtype=np.float32)
    for k in range(c):
        for _ in range(data["blobs_per_class"]):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sig = rng.uniform(h / 12, h / 5)
            pol = rng.integers(0, 2)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
            maps[k, pol] += data["signal_rate"] * blob.astype(np.float32)
    return np.clip(maps, 0.0, 0.95).reshape(c, -1)


def spread_lengths(n: int, lo: int, hi: int) -> list[int]:
    """``n`` request lengths spread evenly over ``[lo, hi]``: the quantiles
    of the uniform draw, so that every seed serves the same set of lengths
    (the seed only orders them)."""
    return [lo + (i * (hi - lo + 1)) // n for i in range(n)]


def draw_pool(data: dict, lengths, gen: torch.Generator,
              device) -> tuple[list[np.ndarray], torch.Tensor]:
    """Requests of the given ``lengths``: request ``i`` of class
    ``i % num_classes``.  Returns the host streams (``[T_i, n_in]`` float32
    each, what a client hands the server) and the same frames stacked on
    ``device`` (``[sum T_i, n_in]``)."""
    maps = torch.from_numpy(class_rate_maps(data)).to(device)
    cls = torch.cat([torch.full((int(t),), i % data["num_classes"],
                                dtype=torch.long) for i, t in enumerate(lengths)])
    u = torch.rand((len(cls), maps.shape[1]), generator=gen, device=device)
    frames = (u < maps[cls.to(device)]).to(torch.float32)
    host = frames.cpu().numpy()
    ends = np.cumsum([int(t) for t in lengths])
    return list(np.split(host, ends[:-1])), frames
