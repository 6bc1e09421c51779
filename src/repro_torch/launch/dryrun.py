"""Multi-pod dry-run of the port: every (architecture x shape x mesh) cell
run on the production mesh's rules on meta tensors, and counted.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--rules sp] [--out results/dryrun] \\
      [--device meta|cuda]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The JAX package lowers and compiles each cell on the (16, 16) or (2, 16,
16) mesh and reads FLOPs, bytes, collectives and memory out of the
compiled HLO.  The port compiles nothing.  Its counterpart of "lower and
compile" is one run of the cell's step (training step, prefill or decode
step, through the entry points a user calls) under the production mesh's
sharding rules, on **meta tensors** (``--device meta``, the default):
every shape is checked end to end and no storage is allocated.  The mesh
is spoofed (256 or 512 shards of the one device), so the meshed MoE and
the sequence-parallel decode run every shard's body.  ``--device cuda``
runs the same cell on the card, for a cell that fits it.  The counts are
of aten ops, not HLO (:mod:`repro_torch.launch.hlo_flops`).

Depth: a cell is run at two periods of its family's layer pattern (a
period is one layer; for Zamba2 one group of ``hybrid_period`` mamba
layers and the shared block) and at one period more (Whisper's encoder
and decoder each one layer deeper in turn), and its counts extrapolated
linearly to the config's depth (:func:`~repro_torch.launch.hlo_flops.extrapolate`), equal
in integers to running every layer (``full_depth=True``).  The
microbatch count follows the full depth's parameters.

Placement, as the port runs a meshed step: the parameters, the optimiser
state, the cache and the inputs all live on the mesh's first device (the
dense layers run there unpartitioned; the meshed pieces copy each
shard's slice to its device).  So ``memory`` is the first device's:
``argument_size_in_bytes`` the whole state plus the inputs,
``temp_size_in_bytes`` the peak of live bytes outside them (the step's
outputs included), ``alias_size_in_bytes`` the donated train state or
cache.  ``roofline`` splits FLOPs and bytes ideally over the mesh's
devices, as if every op were partitioned; the collectives are the mean
device's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.configs.common import ArchConfig, ShapeSpec
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch.hlo_analysis import (collective_bytes, model_flops,
                                             roofline_terms)
from repro_torch.launch.hlo_flops import CostCounter, extrapolate, to_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import (DECODE_RULES, DECODE_RULES_SP,
                                           TRAIN_RULES, activate)

PLACEMENT = ("state, cache and inputs on the mesh's first device (the "
             "port's placement); memory is that device's")
SPLIT = ("ideal: FLOPs and bytes of the whole program divided by "
         "n_devices; collectives the mean device's")


# the depth, in periods, that extrapolation starts from: the first layer
# has no layer before it, so at one period the peak of live bytes may sit
# elsewhere than at every greater depth; from two on it grows linearly
BASE_PERIODS = 2


@dataclasses.dataclass
class Traced:
    """A cell's config and counts: :meth:`CostCounter.tally` at the
    config's depth, with ``raw_flops`` (FlopCounterMode's own total),
    ``output_bytes`` and ``alias_bytes`` (the step's outputs and donated
    arguments)."""

    cfg: ArchConfig
    tally: dict[str, int]


def _depth_fields(cfg: ArchConfig) -> dict[str, int]:
    """The config's layer counts and the period of each."""
    period = cfg.hybrid_period if cfg.family == "hybrid" else 1
    fields = {"n_layers": period}
    if cfg.family == "encdec":
        fields["n_encoder_layers"] = 1
    return fields


def microbatches(cfg: ArchConfig, global_batch: int) -> int:
    """The reference's gradient-accumulation rule: 8 microbatches over 50 B
    parameters, 4 over 15 B, else 1 (and 1 where the batch does not
    split)."""
    n_params_b = sum(t.numel() for t in tree_leaves(
        build_model(cfg).abstract_params())) / 1e9
    micro = 8 if n_params_b > 50 else (4 if n_params_b > 15 else 1)
    return micro if global_batch % micro == 0 else 1


def active_params(cfg: ArchConfig) -> int:
    """Parameters a token meets: all of them, less the ``(E - k) / E`` of
    the expert weights it is not routed to."""
    tree = build_model(cfg).abstract_params()
    total = sum(t.numel() for t in tree_leaves(tree))
    if not cfg.n_experts:
        return total
    experts = sum(v.numel() for k, v in tree["layers"].items()
                  if k.startswith("we_"))
    return total - experts * (cfg.n_experts - cfg.top_k) // cfg.n_experts


def _on(tree, device: torch.device):
    """A meta tree as is on meta, else zeros of its shapes on ``device``."""
    if device.type == "meta":
        return tree
    return {k: _on(v, device) if isinstance(v, dict) else
            torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in tree.items()}


def trace_step(cfg: ArchConfig, shape, mesh, rule_map, attn_impl: str,
               device: torch.device, micro: int = 1) -> dict[str, int]:
    """One run of the cell's step at ``cfg``'s depth under the counters:
    the tally, with ``raw_flops``, ``output_bytes`` and ``alias_bytes``."""
    bundle = build_model(cfg)
    kind = shape.kind
    with activate(mesh, rule_map) as rules:
        dtype = torch.float32 if kind == "train" else torch.bfloat16
        if device.type == "meta":
            params = bundle.abstract_params(dtype)
        else:
            params = bundle.init(seed=0, dtype=dtype, device=device)
        inputs = _on(bundle.input_specs(shape)[0], device)
        if kind == "train":
            from repro_torch.engine.train_loop import make_train_step
            step = make_train_step(bundle.loss, AdamWConfig(),
                                   microbatches=micro)
            state = {"params": params, "opt": adamw_init(params)}
            args, donated = (state, inputs), state

            def run():
                return step(state, inputs)
        elif kind == "prefill":
            args, donated = (params, inputs), ()

            def run():
                with torch.no_grad():
                    return bundle.prefill(params, inputs)
        else:
            cache = _on(bundle.cache_spec(shape.global_batch,
                                          shape.seq_len)[0], device)
            args, donated = (params, cache, inputs), cache
            impl = {}
            if attn_impl == "sp":
                from repro_torch.parallel.decode import make_sp_attention
                impl["attn_impl"] = make_sp_attention(rules.mesh)

            def run():
                with torch.no_grad():
                    return bundle.decode(params, cache, inputs, **impl)
        counter = CostCounter(arguments=args)
        with counter, FlopCounterMode(display=False) as fc:
            out = run()
        tally = counter.tally()
        tally["raw_flops"] = int(fc.get_total_flops())
        tally["output_bytes"] = sum(t.numel() * t.element_size()
                                    for t in tree_leaves(out))
        tally["alias_bytes"] = sum(t.numel() * t.element_size()
                                   for t in tree_leaves(donated))
    return tally


def lower_cell(arch: str, shape_name: str | ShapeSpec, mesh,
               rules_name: str = "base", attn_impl: str = "baseline", *,
               device="meta", full_depth: bool = False,
               cfg: ArchConfig | None = None):
    """Run and count one cell (the port's "lower + compile").  Returns
    ``(traced, meta dict)``.  ``shape_name`` names a cell of ``SHAPES`` or
    is a :class:`ShapeSpec` of its own; ``cfg`` overrides the registry's
    config of ``arch``."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    kind = shape.kind
    dev = torch.device(device)
    rule_map = {"base": TRAIN_RULES if kind == "train" else DECODE_RULES,
                "sp": DECODE_RULES_SP}[rules_name]
    micro = microbatches(cfg, shape.global_batch) if kind == "train" else 1

    def at(depths: dict[str, int]) -> dict[str, int]:
        return trace_step(dataclasses.replace(cfg, **depths), shape, mesh,
                          rule_map, attn_impl, dev, micro)

    periods = _depth_fields(cfg)
    full = {k: getattr(cfg, k) for k in periods}
    base = {k: BASE_PERIODS * p for k, p in periods.items()}
    adds = [(full[k] - base[k]) // p for k, p in periods.items()]
    t0 = time.monotonic()
    if full_depth or min(adds) < 0 or not any(adds):
        tally, traced_at = at(full), [full]
    else:
        steps = [{**base, k: base[k] + p} for k, p in periods.items()]
        tally = extrapolate(at(base), [at(s) for s in steps], adds)
        traced_at = [base, *steps]
    compile_s = time.monotonic() - t0
    return Traced(cfg, tally), {
        "arch": arch, "shape": shape.name, "kind": kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "mesh": list(mesh.dims), "rules": rules_name, "attn": attn_impl,
        "compile_s": compile_s, "device": dev.type, "microbatches": micro,
        "traced_depths": traced_at}


def compiled_cost_analysis(traced: Traced) -> dict:
    """The library's own count of the step: ``torch.utils.flop_counter``'s
    total, matmul-family FLOPs only (the reference's ``cost_analysis()``)."""
    return {"flops": float(traced.tally["raw_flops"])}


def analyze(traced: Traced, meta: dict, n_devices: int) -> dict:
    """The cell's record: the reference's keys (``cost_analysis_raw``,
    ``loop_aware``, ``collectives``, ``memory``, ``roofline``) and the
    model FLOPs with their share of the counted FLOPs."""
    t = traced.tally
    coll = collective_bytes(to_cost(t, n_devices))
    terms = roofline_terms({"flops": t["flops"] / n_devices,
                            "bytes accessed": t["bytes"] / n_devices},
                           coll, n_devices)
    tokens = meta["global_batch"] * (1 if meta["kind"] == "decode"
                                     else meta["seq_len"])
    mf = model_flops(active_params(traced.cfg), tokens, meta["kind"])
    return {**meta,
            "cost_analysis_raw": compiled_cost_analysis(traced),
            "loop_aware": {"flops": t["flops"], "dot_flops": t["dot_flops"],
                           "bytes": t["bytes"]},
            "collectives": {"bytes": coll.bytes_by_kind,
                            "counts": coll.count_by_kind},
            "memory": {"argument_size_in_bytes": t["argument_bytes"],
                       "output_size_in_bytes": t["output_bytes"],
                       "temp_size_in_bytes": t["temp_bytes"],
                       "alias_size_in_bytes": t["alias_bytes"],
                       "placement": PLACEMENT},
            "model_flops": mf,
            "useful_ratio": mf / t["flops"] if t["flops"] else 0.0,
            "roofline": {**terms.to_dict(), "split": SPLIT}}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             rules_name: str = "auto", attn_impl: str = "auto",
             verbose: bool = True, *, device="meta") -> dict:
    """Count one cell on the production mesh (spoofed on ``device``) and
    write its JSON to
    ``<out_dir>/{pod,multipod}/<arch>_<shape>[_<rules>_<attn>].json``."""
    # production defaults: SP flash-decode for decode cells
    is_decode = SHAPES[shape_name].kind == "decode"
    explicit = (rules_name != "auto" or attn_impl != "auto")
    if rules_name == "auto":
        rules_name = "sp" if is_decode else "base"
    if attn_impl == "auto":
        attn_impl = "sp" if is_decode else "baseline"
    mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                spoof=512 if multi_pod else 256)
    traced, meta = lower_cell(arch, shape_name, mesh, rules_name, attn_impl,
                              device=device)
    rec = analyze(traced, meta, mesh.size)
    tag = "multipod" if multi_pod else "pod"
    suffix = f"_{rules_name}_{attn_impl}" if explicit else ""
    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    path = os.path.join(out_dir, tag, f"{arch}_{shape_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        r, m = rec["roofline"], rec["memory"]
        print(f"[dryrun OK] {arch} x {shape_name} mesh={meta['mesh']} "
              f"trace={meta['compile_s']:.1f}s "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"dominant={r['dominant']} "
              f"useful={rec['useful_ratio']:.3f}")
        print(f"  memory (first device): args={m['argument_size_in_bytes']} "
              f"out={m['output_size_in_bytes']} "
              f"temp={m['temp_size_in_bytes']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="auto", choices=["auto", "base", "sp"],
                    help="auto = sp flash-decode for decode cells, base "
                         "elsewhere")
    ap.add_argument("--attn", default="auto",
                    choices=["auto", "baseline", "sp"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: shapes only, no storage; cuda: the cell "
                         "run on the card (it must fit)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS
                 for s in applicable_shapes(get_config(a))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    failures = []
    t0 = time.monotonic()
    for a, s in cells:
        try:
            run_cell(a, s, args.multi_pod, args.out, args.rules, args.attn,
                     device=args.device)
        except Exception:
            failures.append((a, s))
            print(f"[dryrun FAIL] {a} x {s}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print(f"all {len(cells)} cells passed in "
          f"{time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main()
