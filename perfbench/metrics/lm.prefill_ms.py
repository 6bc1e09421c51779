"""Mean ms of a call's prefill (host clock, synced by ``serve``): the
``prefill_s`` of the window's calls."""


def read(run):
    calls = getattr(run.cell, "calls", None)
    if not calls:
        return None
    return 1e3 * sum(c[1] for c in calls) / len(calls)
