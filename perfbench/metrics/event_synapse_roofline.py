"""Share (%) of its roofline that the event-accumulation kernel reached in
the window: the least time the window's calls need (``counts.
synapse_work`` of each call's real rows and valid events, every layer)
over the device time of the ``stream_kernel`` launches in the trace."""

import torch

from perfbench import counts


def read(run):
    if run.trace is None or not run.on_chip:
        return None
    spent = run.trace.device_seconds("stream_kernel")
    if spent <= 0:
        return None
    card = counts.peak(torch.cuda.get_device_name(run.device))
    sizes, bits = run.config["layer_sizes"], run.config["quant_bits"]
    need = 0.0
    for g, times in run.cell.times_served().items():
        for li, x in enumerate(run.cell.layer_inputs(g)):
            need += times * counts.bound_s(
                *counts.synapse_work(x, sizes[li + 1], bits[li]), card)
    return 100.0 * need / spent
