"""Closed-loop batch traffic: one client calls ``run_bucketed`` on a list
of requests, waits for every result, and calls again.

The cell file's ``traffic`` gives ``requests_per_call``, the request
``lengths`` range (spread evenly, ordered by the seed: every seed serves
the same lengths), ``pool_calls`` (how many distinct calls the pool holds;
the window cycles through them), ``with_stats`` and the bucket ``policy``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import snn
from perfbench.drivers import common
from perfbench.traffic.dvs import spread_lengths


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.engine import BucketPolicy

        tr = self.traffic
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.system = snn.build(self.cfg, gen, self.device)
        per_call = tr["requests_per_call"]
        self.lengths = self.pool_lengths()
        self.streams, self.frames = snn.pool(self.cfg, self.lengths, gen,
                                             self.device)
        self.groups = [list(range(g * per_call, (g + 1) * per_call))
                       for g in range(tr["pool_calls"])]
        self.policy = BucketPolicy(**{k: tuple(v) for k, v in
                                      tr["policy"].items()})
        for g in range(len(self.groups)):        # every shape the window uses
            self._call(g, [])
        common.sync(self.device)

    def pool_lengths(self) -> list[int]:
        """Each pool call's lengths: the same spread in every call, in an
        order drawn from the seed."""
        tr, order = self.traffic, np.random.default_rng(self.seed)
        lengths = []
        for _ in range(tr["pool_calls"]):
            ls = spread_lengths(tr["requests_per_call"], *tr["lengths"])
            order.shuffle(ls)
            lengths += ls
        return lengths

    def _call(self, g: int, telemetry: list):
        from repro_torch.engine import run_bucketed
        with record_function("run_bucketed"):
            return run_bucketed(self.system["packed"],
                                [self.streams[i] for i in self.groups[g]],
                                policy=self.policy,
                                with_stats=self.traffic["with_stats"],
                                telemetry=telemetry)

    def window(self, seconds: float) -> None:
        from repro_torch.kernels import _build
        self.telemetry, self.served = [], []
        launches0 = dict(_build.launches)
        t0 = time.perf_counter()
        g = 0
        while True:
            self.served.append((g, self._call(g, self.telemetry)))
            g = (g + 1) % len(self.groups)
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.launches = {k: v - launches0[k] for k, v in _build.launches.items()}
        self.attempted = sum(len(self.groups[g]) for g, _ in self.served)

    def release(self) -> None:
        self.system.pop("packed")

    def check(self) -> dict:
        ref = common.reference(self.cfg, self.system["weights"], self.frames,
                               self.lengths)
        self.reference = ref
        pairs = ((i, res) for g, results in self.served
                 for i, res in zip(self.groups[g], results))
        return common.compare(pairs, ref, stats=self.traffic["with_stats"])

    def times_served(self) -> dict:
        """How many times the window served each of the pool's calls."""
        out: dict = {}
        for g, _ in self.served:
            out[g] = out.get(g, 0) + 1
        return out

    def layer_inputs(self, g: int) -> list:
        """Each layer's input spikes over the real rows of pool call ``g``,
        from the reference (which the check holds the program's to)."""
        ends = np.cumsum(self.lengths)
        lo, hi = ends[self.groups[g][0]] - self.lengths[self.groups[g][0]], \
            ends[self.groups[g][-1]]
        return [x[lo:hi] for x in self.reference["raw"]["inputs"]]
