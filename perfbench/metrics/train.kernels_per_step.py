"""Operations on the card a training step: the traced window's device
operations (kernels, copies, sets) over its steps."""


def read(run):
    if run.trace is None or not run.on_chip or not run.cell.steps:
        return None
    return len(run.trace.ops) / run.cell.steps
