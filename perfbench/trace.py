"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer readers and the result's ``breakdown`` need.

The window is the harness's own ``window`` span.  Device operations are the
trace's events on the card (kernels, copies, sets), without the
projections of host annotations onto the card's timeline.  Busy time is
the union of the operations' intervals inside the window; an idle gap is
a stretch of the window in which none ran, named by the innermost harness
span the host was in at the gap's middle (``host`` where it was in none).
"""

from __future__ import annotations

import bisect
import dataclasses

from torch.autograd import DeviceType

SPANS = ("window", "map_model", "pack", "run_bucketed", "server.submit",
         "server.poll", "train.step")
TOP = 10
NEST = 4                   # how deep the harness nests its spans


@dataclasses.dataclass
class Summary:
    window: tuple[float, float]          # seconds, the trace's clock
    ops: list[tuple[str, float, float]]  # (name, start, end) on the card
    spans: list[tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the operations' intervals, clipped to the window."""
        lo, hi = self.window
        merged: list[list[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_seconds(self, needle: str) -> float:
        """Device time of the operations whose name holds ``needle``."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.ops
                   if needle in n and e > lo and s < hi)

    def device_ops(self) -> list:
        tot: dict = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n[:200], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """Idle seconds of the window summed by what the host was doing."""
        lo, hi = self.window
        edges, t = [], lo
        for s, e in self.busy():
            if s > t:
                edges.append((t, s))
            t = e
        if hi > t:
            edges.append((t, hi))
        spans = sorted((s for s in self.spans if s[0] != "window"),
                       key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        tot: dict = {}
        for s, e in edges:
            mid = 0.5 * (s + e)
            name = "host"
            j = bisect.bisect_right(starts, mid)
            # the harness's spans follow one another, nested a few deep:
            # the innermost one holding ``mid`` starts last before it
            for sp in reversed(spans[max(0, j - NEST):j]):
                if sp[2] >= mid:
                    name = sp[0]
                    break
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(prof) -> Summary:
    """The window, the card's operations and the harness spans of a
    finished ``torch.profiler.profile``."""
    ops, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        on_card = ev.device_type() == DeviceType.CUDA
        if name in SPANS:
            if not on_card:
                spans.append((name, s, e))
                if name == "window":
                    window = (s, e)
        elif on_card:
            ops.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Summary(window=window, ops=ops, spans=spans)
