"""The training step's share (%) of the card's float32 peak (TF32 off):
6 x parameters x T x batch operations a step (forward and backward of
every layer's product, every time step), over the window's seconds a
step."""

import torch

from perfbench import counts


def read(run):
    if not run.on_chip or not run.cell.steps:
        return None
    sizes = run.config["layer_sizes"]
    params = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    tr = run.cell.traffic
    ops = 6 * params * tr["T"] * tr["batch"] * run.cell.steps
    card = counts.peak(torch.cuda.get_device_name(run.device))
    return 100.0 * ops / run.cell.window_s / card["f32_flop_per_s"]
