"""Mean ms of one engine call (pad to results on the host), from the
``seconds`` of the window's ``telemetry`` records."""


def read(run):
    tel = run.cell.telemetry
    return 1e3 * sum(r["seconds"] for r in tel) / len(tel) if tel else None
