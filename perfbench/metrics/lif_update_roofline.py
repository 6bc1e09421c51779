"""Share (%) of its roofline that the LIF kernel reached in the window:
``counts.lif_work`` of every real (request, step, neuron) of each layer
over the memory rate, over the device time of the ``lif_`` kernels in the
trace."""

import torch

from perfbench import counts


def read(run):
    if run.trace is None or not run.on_chip:
        return None
    spent = run.trace.device_seconds("lif_")
    if spent <= 0:
        return None
    card = counts.peak(torch.cuda.get_device_name(run.device))
    sizes = run.config["layer_sizes"]
    rows = sum(run.cell.lengths[i] for g, _ in run.cell.served
               for i in run.cell.groups[g])
    need = sum(counts.lif_work(rows, n) for n in sizes[1:])
    return 100.0 * need / card["hbm_bytes_per_s"] / spent
