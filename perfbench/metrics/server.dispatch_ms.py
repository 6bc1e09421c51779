"""Mean ms of one server dispatch (the engine call and the server's
bookkeeping around it), from ``submit`` or ``poll``: the program's
``server.dispatch`` span."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("server.dispatch")
