"""Mean ms of a decode step (host clock, synced by ``serve``): each call's
``decode_s`` over its ``gen - 1`` steps, averaged over the window's
calls."""


def read(run):
    calls = getattr(run.cell, "calls", None)
    if not calls:
        return None
    steps = run.cell.traffic["gen"] - 1
    return 1e3 * sum(c[2] for c in calls) / len(calls) / steps
