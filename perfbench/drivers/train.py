"""Training traffic: the program's SNN train step, called back to back on
step-keyed batches, each step's metrics read by the host as the program's
train loop reads them.

The cell file's ``traffic`` gives the ``batch``, the time steps ``T`` of
each sample, the ``pool_size`` (samples drawn from the seed in set-up;
batch ``k`` takes rows ``k * batch`` onward, cyclically, so the rows of
the first steps all differ) and Table I's Adam (``lr``, ``b1``, ``b2``,
``eps``), and ``limits``, the check's limit on each number it compares.
Set-up builds the one step object with its state, from the
benchmark's seeded weights, and drives it through the first ``CHECKED``
steps, whose readings the check holds to the reference; the window goes
on from there with the same object.
"""

from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function

from perfbench import snn

CHECKED = 3                # steps the reference follows


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.core.lif import LIFParams
        from repro_torch.engine import MLP_MODEL, SNNTrainConfig
        from repro_torch.engine.snn_train import make_snn_train_step
        from repro_torch.engine.train_loop import init_train_state
        from repro_torch.snn.mlp import SNNConfig

        tr, cfg = self.traffic, self.cfg
        self.draw_inputs()
        model_cfg = SNNConfig(layer_sizes=tuple(cfg["layer_sizes"]),
                              lif=LIFParams(**cfg["lif"]), num_steps=tr["T"])
        opt = SNNTrainConfig(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"],
                             eps=tr["eps"]).adamw()
        self.step_fn = make_snn_train_step(MLP_MODEL, model_cfg, opt)
        self.state = init_train_state(
            None, [w.clone() for w in self.init], opt).as_tree()
        self.losses = []
        for k in range(CHECKED):
            self.losses.append(self._step(k))
            if k == 0:
                self.first_m = [m.clone() for m in self.state["opt"]["m"]]
        self.after = [p.clone() for p in self.state["params"]]

    def draw_inputs(self) -> None:
        """The starting weights and the sample pool, from the seed."""
        tr, cfg = self.traffic, self.cfg
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.init = snn.seeded_weights(cfg, gen, self.device)
        n, t = tr["pool_size"], tr["T"]
        _, frames = snn.pool(cfg, [t] * n, gen, self.device)
        self.samples = frames.reshape(n, t, -1)
        self.labels = torch.arange(n, device=self.device) \
            % cfg["data"]["num_classes"]
        self.lr = torch.full((), float(tr["lr"]), dtype=torch.float32,
                             device=self.device)

    def batch(self, k: int) -> dict:
        b = self.traffic["batch"]
        idx = (torch.arange(b, device=self.device) + k * b) \
            % self.samples.shape[0]
        return {"spikes": self.samples[idx].transpose(0, 1).contiguous(),
                "labels": self.labels[idx], "lr": self.lr}

    def _step(self, k: int) -> float:
        with record_function("train.step"):
            self.state, metrics = self.step_fn(self.state, self.batch(k))
            return float(metrics["loss"])

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        k = CHECKED
        while time.perf_counter() - t0 < seconds:
            self._step(k)
            k += 1
        self.window_s = time.perf_counter() - t0
        self.steps = k - CHECKED
        self.attempted = self.steps * self.traffic["batch"]

    def release(self) -> None:
        self.state = None

    def check(self) -> dict:
        """The first steps' losses, the first gradient as Adam got it
        (its first moment over ``1 - b1``) and the parameters' change
        after ``CHECKED`` steps, each against the reference's."""
        tr = self.traffic
        self.reference = reference(self, tr)
        grads = [m / (1 - tr["b1"]) for m in self.first_m]
        read = gaps(self.losses, grads, self.after, self.init, self.reference)
        checks = {k: (v, tr["limits"][k]) for k, v in read.items()}
        bad = any(v > lim for v, lim in checks.values())
        return dict(checks=checks, attempted=self.attempted,
                    failed=self.attempted if bad else 0)


def reference(cell: Cell, traffic: dict, precision: str = "float32") -> dict:
    """The reference's first ``CHECKED`` steps from the cell's start."""
    from perfbench.reference import snn_train
    batches = [(b["spikes"], b["labels"]) for b in
               (cell.batch(k) for k in range(CHECKED))]
    return snn_train.train(cell.init, batches, cell.cfg["lif"], traffic,
                           precision=precision)


def gaps(losses, first_grad, after, init, ref: dict) -> dict:
    """The numbers compared: the largest relative gap of a step's loss,
    and by the worst leaf the gap of the first gradient's norm and of the
    parameters' change after the checked steps."""
    keep = moving_leaves(ref["first_grad"])
    return dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref["losses"])),
        grad_gap=worst_leaf(first_grad, ref["first_grad"], keep),
        change_gap=worst_leaf([a - p for a, p in zip(after, init)],
                              [a - p for a, p in zip(ref["params"], init)],
                              keep))


def moving_leaves(ref_grads) -> list[bool]:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's (by norm): the others move under Adam by round-off."""
    norms = [float(g.norm()) for g in ref_grads]
    med = statistics.median(norms)
    return [n > 1e-3 * med for n in norms]


def worst_leaf(got, want, keep) -> float:
    """The largest gap between the norms of a leaf on the two sides, over
    the larger of the reference leaf's norm and the median leaf's."""
    ns = [float(w.norm()) for w in want]
    med = statistics.median(ns)
    return max(abs(float(g.norm()) - n) / max(n, med)
               for g, n, k in zip(got, ns, keep) if k)
