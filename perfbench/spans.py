"""The program's stage spans (``repro_torch.engine.tracing.span``) as the
per-layer readers see them: the seconds and count of each stage that
closed while the profiler recorded, kept by the program as its spans
close (``tracing.stage_totals``).  The benchmark profiles the window
alone, so these are the window's.  A program without stage spans has no
``stage_totals``, and every reading is then ``None``."""

from __future__ import annotations


def stage_ms(name: str, per: str | None = None) -> float | None:
    """Milliseconds of the stage ``name`` over the count of the stage
    ``per`` (``name`` itself by default): ``None`` where either never
    closed."""
    try:
        from repro_torch.engine.tracing import stage_totals
    except ImportError:
        return None
    totals = stage_totals()
    if name not in totals or (per or name) not in totals:
        return None
    return 1e3 * totals[name][0] / totals[per or name][1]
