"""Ms a training step spends in the loss's forward (the host's issue of
it): the program's ``train.forward`` spans over its steps, one
``train.optimizer`` span a step."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("train.forward", per="train.optimizer")
