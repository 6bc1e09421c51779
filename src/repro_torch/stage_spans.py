"""Stage spans: named stages inside the port's front end, engine, server,
train step and LM launcher and models.

:func:`span` marks one stage (:data:`STAGE_SPANS`).  While a
``torch.profiler`` records, it opens a profiler range, so the stage sits
on the device trace's clock and names the host's share of every idle gap
of the card, and :func:`stage_totals` sums it; otherwise it costs one flag
read.

A leaf module: it imports only the standard library and torch's profiler
hooks, so the LM models and the engine alike mark their stages without
loading one another.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# The stage spans of the port, outermost first: the server's dispatch, the
# front end's engine call and its stages, the engine's stages inside
# run_batched (``engine.replay``, a captured forward's replay, inside
# ``engine.forward``), the train step's, and the LM launcher's: its prefill
# and decode steps (``launch/serve.py``), each holding the Zamba2 mixers'
# and shared-block applications' (``models/zamba2.py``), a mixer's holding
# its scan kernel's launch (``lm.ssd_scan``, ``kernels/ssd_scan.py``; on
# the kernel path only).  Locked like
# the flight recorder's SPAN_KINDS: the benchmark's readers key on these
# names.
STAGE_SPANS = ("server.dispatch", "serving.execute", "serving.pad",
               "engine.upload", "engine.forward", "engine.replay",
               "engine.readback", "engine.stats", "serving.record",
               "serving.slice", "train.forward", "train.backward",
               "train.optimizer", "lm.prefill", "lm.decode_step",
               "lm.mamba", "lm.shared_block", "lm.ssd_scan")

_OFF = contextlib.nullcontext()
_totals_lock = threading.Lock()
_totals: dict[str, list] = {}


class _Span:
    """One stage span: a profiler range while a profiler records, inside
    which ``clock`` is read on entry (``t0``) and exit (``t1``)."""

    __slots__ = ("name", "clock", "range", "t0", "t1")

    def __init__(self, name: str, clock, profiled: bool):
        self.name, self.clock = name, clock
        self.range = _RecordFunctionFast(name) if profiled else None

    def __enter__(self) -> "_Span":
        if self.range is not None:
            self.range.__enter__()
        self.t0 = self.clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self.clock()
        if self.range is not None:
            self.range.__exit__(*exc)
            with _totals_lock:
                tot = _totals.setdefault(self.name, [0.0, 0])
                tot[0] += self.t1 - self.t0
                tot[1] += 1


def span(name: str, clock=None):
    """A context for the stage ``name`` (one of :data:`STAGE_SPANS`).

    While a ``torch.profiler`` records, it opens a profiler range named
    ``name`` at function scope: the range is on the device trace's clock,
    and the card's timeline carries no copy of it.  With ``clock`` (a
    zero-argument callable, e.g. a server's ``now``), the returned span
    reads it once on entry and once on exit (``.t0``, ``.t1``), inside
    the range, whether or not a profiler records: a caller's own log of
    the stage takes those two reads, so a stage is timed once.  With
    neither, it returns one shared no-op context and makes no range."""
    profiled = _profiler._is_profiler_enabled
    if clock is None and not profiled:
        return _OFF
    return _Span(name, clock or time.perf_counter, profiled)


def stage_totals() -> dict[str, tuple[float, int]]:
    """Seconds (on each span's clock) and count of every stage span that
    closed while a profiler recorded, over the process's life."""
    with _totals_lock:
        return {k: (v[0], v[1]) for k, v in _totals.items()}
