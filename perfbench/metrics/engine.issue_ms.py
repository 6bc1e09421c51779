"""Mean ms an engine call spends issuing every layer's kernels (the host
side of the forward; the card runs behind it): the program's
``engine.forward`` span."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("engine.forward")
