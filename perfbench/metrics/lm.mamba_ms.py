"""Ms a forward (a prefill or a decode step) spends in the Mamba2 mixers,
the host's share: the program's ``lm.mamba`` spans over its forwards."""

from perfbench.lm_counts import stage_ms_per_forward


def read(run):
    return stage_ms_per_forward("lm.mamba")
