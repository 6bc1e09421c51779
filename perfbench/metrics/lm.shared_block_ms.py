"""Ms a forward (a prefill or a decode step) spends in the shared-block
applications with their linears, the host's share: the program's
``lm.shared_block`` spans over its forwards."""

from perfbench.lm_counts import stage_ms_per_forward


def read(run):
    return stage_ms_per_forward("lm.shared_block")
