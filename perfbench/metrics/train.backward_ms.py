"""Ms a training step spends in the gradient (``torch.autograd.grad``): the
program's ``train.backward`` spans over its steps, one ``train.optimizer``
span a step."""

from perfbench.spans import stage_ms


def read(run):
    return stage_ms("train.backward", per="train.optimizer")
