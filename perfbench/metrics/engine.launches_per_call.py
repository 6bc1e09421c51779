"""Hand-written kernel launches an engine call: the program's
``kernels._build.launches`` counters differenced over the window, over
the window's engine calls (the counters count launches on the card only)."""


def read(run):
    tel = run.cell.telemetry
    if not run.on_chip or not tel:
        return None
    return sum(run.cell.launches.values()) / len(tel)
