"""The whole serving call's share (%) of the card's dense bf16 peak: the
model FLOPs of every call of the window (``lm_counts.call_flops``: two a
weight and token, causal attention, the SSD recurrence) over the window's
host seconds and the peak."""

import torch

from perfbench import lm_counts


def read(run):
    calls = getattr(run.cell, "calls", None)
    if not run.on_chip or not calls:
        return None
    tr = run.cell.traffic
    flops = len(calls) * lm_counts.call_flops(
        run.config, tr["requests_per_call"], tr["prompt_len"], tr["gen"])
    card = lm_counts.peak(torch.cuda.get_device_name(run.device))
    return 100.0 * flops / run.cell.window_s / card["bf16_flop_per_s"]
