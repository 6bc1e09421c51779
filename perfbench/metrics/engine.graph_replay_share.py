"""Share of the window's engine forwards that replayed a captured CUDA
graph: the count of the program's ``engine.replay`` span over that of
``engine.forward`` (``tracing.stage_totals``).  A program without the
``engine.replay`` span or without stage totals reads ``None``; one that
ran no forward too."""


def read(run):
    try:
        from repro_torch.engine import tracing
    except ImportError:
        return None
    stage_totals = getattr(tracing, "stage_totals", None)
    if stage_totals is None or \
            "engine.replay" not in getattr(tracing, "STAGE_SPANS", ()):
        return None
    totals = stage_totals()
    forwards = totals.get("engine.forward", (0.0, 0))[1]
    if not forwards:
        return None
    return totals.get("engine.replay", (0.0, 0))[1] / forwards
