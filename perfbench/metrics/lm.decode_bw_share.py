"""The decode step's share (%) of its memory roofline: the least bytes of
a step (``lm_counts.decode_step_bytes``: weights, each shared block once
per application, SSM states read and written, the valid KV) over the
card's HBM rate, over the mean decode step's time (``lm.decode_step_ms``).
"""

import torch

from perfbench import lm_counts


def read(run):
    calls = getattr(run.cell, "calls", None)
    if not run.on_chip or not calls:
        return None
    tr = run.cell.traffic
    step_s = sum(c[2] for c in calls) / len(calls) / (tr["gen"] - 1)
    card = lm_counts.peak(torch.cuda.get_device_name(run.device))
    need = lm_counts.decode_step_bytes(run.config, tr["requests_per_call"],
                                       tr["prompt_len"], tr["gen"])
    return 100.0 * need / card["hbm_bytes_per_s"] / step_s
