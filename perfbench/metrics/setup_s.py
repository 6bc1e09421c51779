"""Set-up seconds on the host clock: from the process's start (imports,
kernel build or load, weights, mapping, packing, request pool) to the end
of the warm-up of every shape the window uses."""


def read(run):
    return run.setup_s
