"""Ms a training step spends in the Adam update: the program's
``train.optimizer`` spans over their count, one a step."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("train.optimizer")
