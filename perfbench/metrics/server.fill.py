"""Mean bucket fill of the window's dispatches (requests over padded batch
rows): a ``FlightRecorder``'s lifetime ``hist["fill"]`` differenced over
the window (the recorder rides the traced run only)."""


def read(run):
    before, after = run.cell.before.get("fill"), run.cell.after.get("fill")
    if before is None or after[1] <= before[1]:
        return None
    return (after[0] - before[0]) / (after[1] - before[1])
