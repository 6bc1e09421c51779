"""The oracle-equivalence sweep of the JAX package's suite
(``tests/test_equivalence_prop.py``), for the port: its 64 seeded case
descriptors and the case -> (layers, spikes) function, drawn exactly as the
reference's ``build_case`` draws them.

This module imports numpy and ``repro_torch`` only, so that the card's
smoke script (``chip_smoke.py``) runs the same cases without JAX.  The
CPU twin (``tests/test_torch_equivalence_prop.py``) first holds
:func:`sweep_cases` equal to the reference's ``_sweep_cases()``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import layers as port_layers
from repro_torch.core.accelerator import map_model
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.lif import LIFParams


def dense_case(seed, widths, density, batch, t, p_spike, max_events,
               engines, caps, beta=0.8, threshold=0.7, compress=False,
               quant_bits=8):
    """A dense stack's case descriptor (the reference's ``_dense_case``)."""
    return {"seed": seed, "in_shape": [widths[0], 1, 1],
            "layers": [{"kind": "dense", "n_out": n, "density": density}
                       for n in widths[1:]],
            "batch": batch, "t": t, "p_spike": p_spike,
            "max_events": max_events, "n_engines": engines, "n_caps": caps,
            "beta": beta, "threshold": threshold, "compress": compress,
            "quant_bits": quant_bits}


def sweep_cases() -> list[dict]:
    """The 64 deterministic cases: dense multi-round stacks, conv
    stride/pad/pool stacks, MEM_E caps (depth 0 at dense seeds 5 and 10),
    compression, and mixed 2/4/8-bit packed stacks."""
    cases = []
    for seed in range(16):
        cases.append(dense_case(
            seed=seed, widths=[6 + seed % 7, 30, 5],   # 30 > engines*caps
            density=0.3 + 0.05 * (seed % 8), batch=2, t=5,
            p_spike=0.1 + 0.05 * (seed % 10),
            max_events=None if seed % 3 == 0 else seed % 5,
            engines=1 + seed % 3, caps=3 + seed % 4,
            compress=seed % 2 == 1))
    for seed in range(16):
        cases.append({
            "seed": 1000 + seed, "in_shape": [1 + seed % 2, 5 + seed % 3,
                                              5 + seed % 3],
            "layers": [
                {"kind": "conv", "c_out": 1 + seed % 3, "k": 2 + seed % 2,
                 "stride": 1 + seed % 2, "padding": seed % 2,
                 "density": 0.4 + 0.06 * (seed % 8)},
                {"kind": "pool", "pool": 2},
                {"kind": "dense", "n_out": 4, "density": 0.8}],
            "batch": 2, "t": 4, "p_spike": 0.25,
            "max_events": None if seed % 2 else 4,
            "n_engines": 2 + seed % 3, "n_caps": 4 + seed % 3,
            "beta": 0.8, "threshold": 0.7,
            "compress": seed % 3 == 1})
    for seed in range(16):
        cases.append({
            "seed": 2000 + seed, "in_shape": [2, 6, 6],
            "layers": [
                {"kind": "conv", "c_out": 2, "k": 3, "stride": 1,
                 "padding": 1, "density": 0.7},
                {"kind": "conv", "c_out": 3, "k": 2, "stride": 2,
                 "padding": 0, "density": 0.9},
                {"kind": "dense", "n_out": 6, "density": 0.5}],
            "batch": 3, "t": 4, "p_spike": 0.1 + 0.04 * (seed % 6),
            "max_events": None if seed % 4 else 8,
            "n_engines": 3, "n_caps": 5,
            "beta": 0.9, "threshold": 0.5,
            "compress": seed % 2 == 0})
    # mixed precision: per-layer 2/4/8-bit words through the packed-operand
    # kernel, crossed with compression and MEM_E caps
    bit_menu = [[4, 8], [8, 4], [4, 4], [2, 8], [8, 2], [2, 4]]
    for seed in range(8):
        cases.append(dense_case(
            seed=3000 + seed, widths=[8 + seed % 5, 26, 6],
            density=0.4 + 0.05 * (seed % 6), batch=2, t=5,
            p_spike=0.15 + 0.05 * (seed % 5),
            max_events=None if seed % 2 else 5,
            engines=2 + seed % 2, caps=4 + seed % 3,
            compress=seed % 2 == 1,
            quant_bits=bit_menu[seed % len(bit_menu)]))
    for seed in range(8):
        cases.append({
            "seed": 4000 + seed, "in_shape": [2, 6, 6],
            "layers": [
                {"kind": "conv", "c_out": 2, "k": 3, "stride": 1,
                 "padding": 1, "density": 0.7},
                {"kind": "pool", "pool": 2},
                {"kind": "dense", "n_out": 5, "density": 0.6}],
            "batch": 2, "t": 4, "p_spike": 0.2 + 0.04 * (seed % 4),
            "max_events": None if seed % 3 else 6,
            "n_engines": 3, "n_caps": 5,
            "beta": 0.8, "threshold": 0.6,
            "compress": seed % 2 == 0,
            "quant_bits": [bit_menu[seed % len(bit_menu)][0], 8,
                           bit_menu[seed % len(bit_menu)][1]]})
    return cases


def case_layers(case: dict, rng) -> list[tuple[str, dict]]:
    """A case's layers as ``(kind, payload)`` pairs (``payload`` the
    keyword arguments of the layer class), drawn from ``rng`` in the
    reference's order: per dense layer a normal draw, then the pruning
    draw; per conv layer the same for its kernel; a pool draws nothing."""
    out = []
    shape = tuple(case["in_shape"])            # (c, h, w); dense uses c*h*w
    for ld in case["layers"]:
        if ld["kind"] == "dense":
            n_in = int(np.prod(shape))
            w = rng.normal(0, 0.6, (n_in, ld["n_out"]))
            w[rng.random(w.shape) > ld["density"]] = 0
            # a dense layer must keep >=1 synapse or the stack goes silent
            if (w != 0).sum() == 0:
                w[0, 0] = 0.5
            out.append(("dense", dict(w=w.astype(np.float32))))
            shape = (ld["n_out"], 1, 1)
        elif ld["kind"] == "conv":
            k = rng.normal(0, 0.8, (ld["c_out"], shape[0], ld["k"], ld["k"]))
            k[rng.random(k.shape) > ld["density"]] = 0
            if (k != 0).sum() == 0:
                k[0, 0, 0, 0] = 0.5
            kw = dict(kernel=k.astype(np.float32), in_shape=shape,
                      stride=ld["stride"], padding=ld["padding"])
            out.append(("conv", kw))
            shape = port_layers.Conv2d(**kw).out_shape
        elif ld["kind"] == "pool":
            out.append(("pool", dict(in_shape=shape, pool=ld["pool"])))
            shape = port_layers.SumPool2d(shape, ld["pool"]).out_shape
        else:
            raise ValueError(f"unknown layer kind {ld['kind']!r}")
    return out


def layer_specs(layers, mod=port_layers) -> list:
    """``(kind, payload)`` pairs as layer specs of ``mod`` (the port's
    ``core.layers`` or a module with the same classes)."""
    specs = []
    for kind, kw in layers:
        if kind == "dense":
            specs.append(mod.Dense(**kw))
        elif kind == "conv":
            specs.append(mod.Conv2d(**kw))
        else:
            specs.append(mod.SumPool2d(kw["in_shape"], kw["pool"]))
    return specs


def build_case(case: dict) -> tuple[list[tuple[str, dict]], np.ndarray]:
    """``(layers, spikes [batch, t, n_in])`` of a case: the layers, then
    the spike raster from the same generator."""
    rng = np.random.default_rng(case["seed"])
    layers = case_layers(case, rng)
    n_in = layer_specs(layers[:1])[0].n_src
    spikes = (rng.random((case["batch"], case["t"], n_in))
              < case["p_spike"]).astype(np.float32)
    return layers, spikes


def map_case(case: dict, layers):
    """The port's mapped model of a case (``map_model`` with the case's
    accelerator, LIF, widths and compression)."""
    spec = AcceleratorSpec("prop", n_cores=len(layers),
                           n_engines=case["n_engines"],
                           n_caps=case["n_caps"], weight_mem_bytes=1 << 20)
    return map_model(layer_specs(layers), spec,
                     lif=LIFParams(beta=case["beta"],
                                   threshold=case["threshold"]),
                     quant_bits=case.get("quant_bits", 8),
                     compress=bool(case.get("compress", False)))


# ------------------------------------------------------------ comparisons

STAT_FIELDS = ("cycles", "rows_touched", "engine_ops", "events",
               "sn_bytes_touched")


def oracle_diffs(res, oracles) -> list[str]:
    """Where a ``BatchedRunResult`` differs from the numpy oracle's
    per-sample ``RunResult`` list: spikes, every ``DispatchStats`` field,
    MEM_S&N utilisation, overflow and the energy report; empty when they
    are equal bit for bit."""
    out = []
    if res.out_spikes.shape[0] != len(oracles):
        return [f"batch {res.out_spikes.shape[0]} != {len(oracles)}"]
    for b, oracle in enumerate(oracles):
        if not np.array_equal(res.out_spikes[b], oracle.out_spikes):
            out.append(f"sample {b} spikes")
        for li, (got, want) in enumerate(zip(res.sample_stats(b),
                                             oracle.per_layer_stats)):
            out += [f"sample {b} layer {li} {f}" for f in STAT_FIELDS
                    if not np.array_equal(getattr(got, f),
                                          getattr(want, f))]
            if got.mem_e_peak != want.mem_e_peak:
                out.append(f"sample {b} layer {li} mem_e_peak")
        for li in range(len(oracle.per_layer_util)):
            if not np.array_equal(res.per_layer_util[li][b],
                                  oracle.per_layer_util[li]):
                out.append(f"sample {b} layer {li} util")
            if not np.array_equal(res.overflow[li][b], oracle.overflow[li]):
                out.append(f"sample {b} layer {li} overflow")
        if res.sample_energy(b) != oracle.energy:
            out.append(f"sample {b} energy")
    return out


def batched_diffs(a, b) -> list[str]:
    """Where two ``BatchedRunResult``s differ (spikes, stats, utilisation,
    overflow, energy); empty when they are equal bit for bit."""
    out = [] if np.array_equal(a.out_spikes, b.out_spikes) else ["spikes"]
    if len(a.per_layer_stats) != len(b.per_layer_stats):
        return out + ["layer count"]
    for li, (sa, sb) in enumerate(zip(a.per_layer_stats, b.per_layer_stats)):
        out += [f"layer {li} {f}" for f in (*STAT_FIELDS, "mem_e_peak")
                if not np.array_equal(getattr(sa, f), getattr(sb, f))]
        if not np.array_equal(a.per_layer_util[li], b.per_layer_util[li]):
            out.append(f"layer {li} util")
        if not np.array_equal(a.overflow[li], b.overflow[li]):
            out.append(f"layer {li} overflow")
    out += [f"sample {s} energy" for s in range(a.out_spikes.shape[0])
            if a.sample_energy(s) != b.sample_energy(s)]
    return out
