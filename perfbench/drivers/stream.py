"""Open-loop stream traffic: requests arrive on a Poisson schedule at a
fixed rate into an always-on ``StreamServer`` on the wall clock, whatever
the server's backlog.

The cell file's ``traffic`` gives the ``rate`` (requests a second), the
``slack`` (each request's deadline after its due time), the request
``lengths`` range and ``pool_size`` (requests spread evenly over the
lengths and cycled in an order drawn from the seed), and the server's
bucket ``policy``.  A request's latency runs from its due time to the
moment the client collects its result, so a stalled loop delays every
request due behind it; a rejected request counts as the window's length,
beyond every limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import snn
from perfbench.drivers import common
from perfbench.traffic import arrivals
from perfbench.traffic.dvs import spread_lengths

WARM_ROUNDS = 3            # dispatches of each bucket shape in set-up
DRAIN_S = 60.0             # the longest wait for answers after the close


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tracer = trace

    def setup(self) -> None:
        from repro_torch.engine import (BucketPolicy, FlightRecorder,
                                        StreamServer, WallClock)

        tr = self.traffic
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.system = snn.build(self.cfg, gen, self.device)
        self.lengths = self.pool_lengths()
        self.streams, self.frames = snn.pool(self.cfg, self.lengths, gen,
                                             self.device)
        self.policy = BucketPolicy(**{k: tuple(v) for k, v in
                                      tr["policy"].items()})
        self.recorder = FlightRecorder() if self.tracer else None
        self.server = StreamServer(self.system["packed"], policy=self.policy,
                                   clock=WallClock(),
                                   default_slack=tr["slack"],
                                   tracer=self.recorder)
        by_bucket: dict = {}
        for i, t in enumerate(self.lengths):
            by_bucket.setdefault(self.policy.t_bucket(t), []).append(i)
        for _ in range(WARM_ROUNDS):
            for idx in by_bucket.values():
                for b in self.policy.batch_sizes:
                    for i in (idx * b)[:b]:
                        self.server.submit(self.streams[i])
                    self.server.flush()
        common.sync(self.device)

    def pool_lengths(self) -> list[int]:
        return spread_lengths(self.traffic["pool_size"],
                              *self.traffic["lengths"])

    def window(self, seconds: float) -> None:
        srv = self.server
        due = arrivals.poisson(self.traffic["rate"], seconds, self.seed)
        order = np.random.default_rng(self.seed).permutation(
            len(self.streams))
        self.pool_of = [int(order[k % len(order)]) for k in range(len(due))]
        self.before = _snapshot(srv, self.recorder)
        self.latency = np.full(len(due), np.nan)
        self.rejected = np.zeros(len(due), dtype=bool)
        self.results: list = [None] * len(due)
        rid_of: dict = {}
        lateness = 0.0
        t0 = time.monotonic()
        k = 0

        def collect(done):
            now = time.monotonic()
            for rid, res in done:
                j = rid_of.pop(rid)
                self.results[j] = res
                self.latency[j] = now - (t0 + due[j])

        while k < len(due):
            now = time.monotonic()
            while k < len(due) and t0 + due[k] <= now:
                with record_function("server.submit"):
                    rid = srv.submit(self.streams[self.pool_of[k]],
                                     arrival_t=t0 + due[k])
                lateness = max(lateness, time.monotonic() - (t0 + due[k]))
                if rid is None:
                    self.rejected[k] = True
                    self.latency[k] = seconds
                else:
                    rid_of[rid] = k
                k += 1
            with record_function("server.poll"):
                collect(srv.poll())
            nxt = t0 + due[k] if k < len(due) else None
            nd = srv.next_deadline()
            if nd is not None:
                nxt = nd if nxt is None else min(nxt, nd)
            if nxt is not None:
                time.sleep(max(0.0, nxt - time.monotonic()))
        close = time.monotonic()
        while rid_of and time.monotonic() - close < DRAIN_S:
            with record_function("server.poll"):
                collect(srv.poll())
            nd = srv.next_deadline()
            if nd is not None:
                time.sleep(max(0.0, nd - time.monotonic()))
        with record_function("server.poll"):
            collect(srv.flush())
        self.window_s = time.monotonic() - t0
        self.after = _snapshot(srv, self.recorder)
        self.lateness_s = lateness
        self.attempted = len(due)

    def release(self) -> None:
        self.system.pop("packed")
        self.server = None

    def check(self) -> dict:
        ref = common.reference(self.cfg, self.system["weights"], self.frames,
                               self.lengths)
        self.reference = ref
        pairs = ((self.pool_of[j], res) for j, res in enumerate(self.results)
                 if not self.rejected[j])
        out = common.compare(pairs, ref, stats=False)
        out["attempted"] = self.attempted
        out["failed"] += int(self.rejected.sum())
        return out


def _snapshot(srv, recorder) -> dict:
    """The lifetime counters the per-layer readers difference over the
    window: the server's time to first dispatch and the recorder's fill."""
    snap = dict(ttfd=(srv.metrics.ttfd_hist.total, srv.metrics.ttfd_hist.n))
    if recorder is not None:
        h = recorder.hist["fill"]
        snap["fill"] = (h.total, h.n)
    return snap
