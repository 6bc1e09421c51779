"""Share of the window's prefill mixers whose scan ran the hand-written
kernel: the count of the program's ``lm.ssd_scan`` span over the count of
its ``lm.prefill`` span times the config's ``num_hidden_layers``
(``tracing.stage_totals``).  A program without the ``lm.ssd_scan`` span
or without stage totals reads ``None``; one that ran no prefill too."""


def read(run):
    try:
        from repro_torch.engine import tracing
    except ImportError:
        return None
    stage_totals = getattr(tracing, "stage_totals", None)
    if stage_totals is None or \
            "lm.ssd_scan" not in getattr(tracing, "STAGE_SPANS", ()):
        return None
    totals = stage_totals()
    prefills = totals.get("lm.prefill", (0.0, 0))[1]
    if not prefills:
        return None
    scans = totals.get("lm.ssd_scan", (0.0, 0))[1]
    return scans / (prefills * run.config["num_hidden_layers"])
