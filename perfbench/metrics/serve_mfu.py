"""The whole serving step's share (%) of the card's float32 peak: the
synaptic operations that every request served in the window needs (one add
a valid event and destination, per layer and step, as the reference counts
them; with stats on, the check holds the program's ``engine_ops`` counters
equal to these) over the window's host seconds and the peak."""

import torch

from perfbench import counts


def read(run):
    if not run.on_chip:
        return None
    cell = run.cell
    per_request = [sum(int(op[i].sum()) for op in cell.reference["ops"])
                   for i in range(len(cell.lengths))]
    ops = sum(per_request[i] for g, _ in cell.served for i in cell.groups[g])
    card = counts.peak(torch.cuda.get_device_name(run.device))
    return 100.0 * ops / cell.window_s / card["f32_flop_per_s"] or None
