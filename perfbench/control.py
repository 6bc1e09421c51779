"""The correctness check's control and planted faults, on the card.

    python3 perfbench/control.py --workload cifar10dvs_mlp.batch --seeds 1,2,3
    python3 perfbench/control.py --workload cifar10dvs_mlp.train --seeds 1,2,3 \
        --fault half_the_batch

The control is the reference put in the program's place, computed one
precision below the configuration's (its products in TF32, where the
configuration states float32 with TF32 off), and judged by the same
comparison as a run's answers: over the serving cell's whole request pool,
or over the training cell's checked steps, at the cell's own size.  It has
to come out not correct; its readings are the upper ends under which the
limits are set.  ``--fault`` runs the cell's set-up and check with a fault
planted in the program's timed path instead (``unchanged_state``:
the train step returns its state; ``half_the_batch``: the loss of half the
batch).
Each prints one line a seed with each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cell(workload: str, seed: int, device, root: Path):
    from perfbench import harness
    _, _, cellfile, cfg = harness.load(workload, root)
    mod = harness._module("drivers", cellfile["driver"], root)
    return mod, mod.Cell(cfg, cellfile["traffic"], seed, device), cellfile


def readings(workload: str, seed: int, device="cuda", root: Path = ROOT,
             precision: str = "tf32") -> dict:
    """The control's readings for one seed."""
    import torch
    from perfbench import snn
    from perfbench.drivers import common

    mod, cell, cellfile = _cell(workload, seed, device, root)
    cfg, traffic = cell.cfg, cellfile["traffic"]
    if cellfile["driver"] == "train":
        cell.draw_inputs()
        ref = mod.reference(cell, traffic)
        ctl = mod.reference(cell, traffic, precision=precision)
        read = mod.gaps(ctl["losses"], ctl["first_grad"], ctl["params"],
                        cell.init, ref)
        return dict(checks={k: (v, traffic["limits"][k])
                            for k, v in read.items()})
    gen = torch.Generator(device).manual_seed(seed)
    ws = snn.seeded_weights(cfg, gen, device)
    lengths = cell.pool_lengths()
    _, frames = snn.pool(cfg, lengths, gen, device)
    ref = common.reference(cfg, ws, frames, lengths)
    ctl = common.reference(cfg, ws, frames, lengths, precision=precision)
    got = [types.SimpleNamespace(
        out_spikes=ctl["out"][i],
        stats=[types.SimpleNamespace(events=ev[i], engine_ops=op[i])
               for ev, op in zip(ctl["events"], ctl["ops"])])
        for i in range(len(lengths))]
    return common.compare(enumerate(got), ref,
                          stats=bool(traffic.get("with_stats")))


def planted(workload: str, seed: int, fault: str, device="cuda",
            root: Path = ROOT, seconds: float = 1.0) -> dict:
    """A run's check with ``fault`` planted in the program."""
    from repro_torch.engine import snn_train
    from perfbench import harness

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "unchanged_state":
        real = snn_train.make_snn_train_step

        def make(*a, **k):
            step = real(*a, **k)
            return lambda state, batch: (state, step(state, batch)[1])
        patch(snn_train, "make_snn_train_step", make)
    elif fault == "half_the_batch":
        loss = snn_train.MLP_MODEL.loss

        def half(params, spikes, labels, cfg):
            b = spikes.shape[1] // 2
            return loss(params, spikes[:, :b], labels[:b], cfg)
        patch(snn_train.MLP_MODEL, "loss", half)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        res, _ = harness.run(workload, seed, seconds, False, device=device,
                             root=root)
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
    return dict(checks={k: (c["value"], c["limit"])
                        for k, c in res["checks"].items()},
                correct=res["correct"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import prepare
    prepare()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = (planted(args.workload, seed, args.fault) if args.fault
               else readings(args.workload, seed))
        print("control: " + json.dumps(dict(workload=args.workload,
                                            fault=args.fault, seed=seed,
                                            **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
