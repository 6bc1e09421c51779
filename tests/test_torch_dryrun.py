"""The port's dry-run tools (``repro_torch.launch.{hlo_flops,hlo_analysis,
dryrun}``) against the JAX package's, and the exactness of their counts.

Twins of ``tests/test_system.py``'s three dry-run tests: the scanned
matmul and the scanned psum are held to the reference's own analysis of
the same programs (run in a subprocess on four spoofed XLA devices); the
machinery test, which fails on JAX 0.9.0 (Explicit mesh axes), is held to
the port's own counts on meta and on real CPU tensors.
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as ref_configs
import repro.launch.hlo_analysis as ref_analysis
from repro.models import build_model as ref_build_model

import repro_torch.configs.internlm2_1_8b as internlm2_mod
import repro_torch.launch.dryrun as D
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_smoke_config
from repro_torch.configs.common import ShapeSpec
from repro_torch.core.pytree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.hlo_flops import CostCounter, summarize, to_cost
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel.mesh import fold_sum, mesh_devices
from repro_torch.parallel.moe import moe_ffn_sharded

from _torch_helpers import run_reference

# the two reference programs of tests/test_system.py, analysed by the
# reference's loop-aware HLO counter
_REFERENCE = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.hlo_flops import analyze_hlo
from repro.parallel.compat import compiled_cost_analysis, shard_map

def g(a, b):
    def body(x, _):
        return jnp.tanh(x @ b), None
    x, _ = jax.lax.scan(body, a, None, length=11)
    return x

a = jax.ShapeDtypeStruct((64, 128), jnp.float32)
b = jax.ShapeDtypeStruct((128, 128), jnp.float32)
c = jax.jit(g).lower(a, b).compile()
scan = analyze_hlo(c.as_text())
raw = compiled_cost_analysis(c)["flops"]

mesh = jax.make_mesh((4,), ("x",))

def f(a):
    def body(x, _):
        y = shard_map(lambda v: jax.lax.psum(v, "x"), mesh=mesh,
                      in_specs=P("x"), out_specs=P())(x)
        return jnp.tanh(x * jnp.mean(y)), None
    x, _ = jax.lax.scan(body, a, None, length=5)
    return x

a = jax.ShapeDtypeStruct((16, 64), jnp.float32)
coll = analyze_hlo(jax.jit(f).lower(a).compile().as_text())
print(json.dumps({"dot_flops": scan.dot_flops, "flops": scan.flops,
                  "raw": raw, "coll_counts": coll.coll_counts,
                  "coll_bytes": coll.coll_bytes}))
"""


@pytest.fixture(scope="module")
def reference():
    return json.loads(run_reference(_REFERENCE, devices=4)
                      .strip().splitlines()[-1])


def test_scan_twin_counts_every_trip(reference):
    """11 trips of ``tanh(x @ b)`` at (64, 128) x (128, 128): the port's
    loop counts every trip, as the reference's while multiplier does.
    The dot FLOPs equal the reference's exactly; the total is the dots
    plus one FLOP per tanh element, within the trip count of XLA's (its
    loop counter's adds); eager mode has no loop to undercount, so
    FlopCounterMode's own total equals the dot FLOPs."""
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 128, device="meta")
    with CostCounter(arguments=(a, b)) as c, \
            FlopCounterMode(display=False) as fc:
        x = a
        for _ in range(11):
            x = torch.tanh(x @ b)
    cost = to_cost(c.tally())
    assert cost.dot_flops == reference["dot_flops"] == 11 * 2 * 64 * 128 * 128
    assert cost.flops == 23158784 == cost.dot_flops + 11 * 64 * 128
    assert abs(cost.flops - reference["flops"]) <= 11
    assert fc.get_total_flops() == cost.dot_flops
    assert reference["raw"] < cost.dot_flops / 5     # the reference's undercount


def test_collective_twin_counts_every_trip(reference):
    """Five trips of a psum over a (4,) mesh of ``[16, 64]`` float32 (a
    ``[4, 64]`` slice a shard): five all-reduces of 1024 result bytes a
    device, as the reference counts.  The reference's compiled program
    also holds six all-gathers that GSPMD inserted to replicate ``x`` for
    the elementwise step; the port's one-process mesh has none: the step
    reads ``x`` on the mesh's first device, and only the fold is a
    collective."""
    devices = mesh_devices(4, device="cpu", spoof=4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 64)).astype(np.float32))
    with CostCounter(arguments=(x,)) as c:
        for _ in range(5):
            y = fold_sum(list(x.split(4)), devices)[0]
            x = torch.tanh(x * torch.mean(y))
    cost = to_cost(c.tally(), n_devices=4)
    assert cost.coll_counts["all-reduce"] == 5 == \
        reference["coll_counts"]["all-reduce"]
    assert cost.coll_bytes["all-reduce"] == 5120 == \
        reference["coll_bytes"]["all-reduce"]
    assert reference["coll_counts"]["all-gather"] == 6
    assert cost.coll_counts["all-gather"] == 0
    assert cost.total_coll_bytes == 5120
    stats = H.collective_bytes(cost)
    assert stats.count_by_kind["all-reduce"] == 5
    assert stats.total_bytes == summarize(cost)["total_coll_bytes"] == 5120


@pytest.fixture
def smoke_internlm2(monkeypatch):
    """The reference test's cut: the smoke InternLM2 as the registry's
    config, train_4k at seq 64, batch 8."""
    monkeypatch.setattr(internlm2_mod, "CONFIG", internlm2_mod.SMOKE)
    monkeypatch.setattr(D, "SHAPES", {
        **D.SHAPES, "train_4k": ShapeSpec("train_4k", 64, 8, "train")})


def test_dryrun_machinery_small_mesh(smoke_internlm2):
    """The dry-run path (run -> count -> analyze) end to end on a spoofed
    (4, 2) meta mesh with the smoke InternLM2: a positive compute term,
    more loop-aware FLOPs than the library's matmul-only count, at least
    the model FLOPs in dots (remat recomputes the forward); the same cell
    on real CPU tensors counts the same."""
    mesh = make_mesh((4, 2), ("data", "model"), device="meta", spoof=8)
    traced, meta = D.lower_cell("internlm2_1_8b", "train_4k", mesh)
    rec = D.analyze(traced, meta, 8)
    assert rec["roofline"]["compute_s"] > 0
    assert rec["loop_aware"]["flops"] > rec["cost_analysis_raw"]["flops"]
    assert rec["loop_aware"]["dot_flops"] >= rec["model_flops"] > 0
    assert rec["mesh"] == [4, 2] and rec["kind"] == "train"
    cpu_mesh = make_mesh((4, 2), ("data", "model"), device="cpu", spoof=8)
    on_cpu, _ = D.lower_cell("internlm2_1_8b", "train_4k", cpu_mesh,
                             device="cpu")
    assert on_cpu.tally == traced.tally


_SMOKE_SHAPES = {"train_4k": ShapeSpec("train_4k", 32, 4, "train"),
                 "prefill_32k": ShapeSpec("prefill_32k", 32, 2, "prefill"),
                 "decode_32k": ShapeSpec("decode_32k", 32, 2, "decode"),
                 "long_500k": ShapeSpec("long_500k", 64, 1, "decode")}
_CELLS = [(a, s) for a in ARCH_IDS
          for s in applicable_shapes(get_smoke_config(a))]


def _deep_smoke(arch):
    """The smoke config with its depth raised past the extrapolation's
    traced depths (two and three periods)."""
    cfg = get_smoke_config(arch)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=4 * cfg.hybrid_period)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=5, n_encoder_layers=4)
    return dataclasses.replace(cfg, n_layers=5)


@pytest.mark.parametrize("arch,shape_name", _CELLS)
def test_depth_extrapolation_is_exact(monkeypatch, arch, shape_name):
    """Every count of a cell extrapolated from two and three periods of
    its layer pattern (FLOPs, bytes, collectives, argument, output,
    donated and peak live bytes) equals the count of running every
    layer, in integers, on a spoofed (2, 2) meta mesh (the meshed MoE
    and the SP decode run on it)."""
    monkeypatch.setattr(D, "SHAPES", _SMOKE_SHAPES)
    cfg = _deep_smoke(arch)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta", spoof=4)
    rules = "sp" if _SMOKE_SHAPES[shape_name].kind == "decode" else "base"
    attn = "sp" if rules == "sp" else "baseline"
    ext, meta = D.lower_cell(arch, shape_name, mesh, rules, attn, cfg=cfg)
    full, _ = D.lower_cell(arch, shape_name, mesh, rules, attn, cfg=cfg,
                           full_depth=True)
    assert len(meta["traced_depths"]) > 1          # extrapolated, not run
    assert all(isinstance(v, int) for v in ext.tally.values())
    assert ext.tally == full.tally


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ARCH_IDS
    for s in ref_configs.applicable_shapes(ref_configs.get_config(a))])
def test_input_specs_match_reference(arch, shape_name):
    """``ModelBundle.input_specs`` gives the reference's names, shapes,
    dtypes and logical axes for every architecture and shape cell, as
    meta tensors."""
    from repro_torch.configs import SHAPES, get_config
    want, want_axes = ref_build_model(ref_configs.get_config(arch)) \
        .input_specs(ref_configs.SHAPES[shape_name])
    got, got_axes = build_model(get_config(arch)).input_specs(
        SHAPES[shape_name])
    assert got.keys() == want.keys() and got_axes == want_axes
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert jnp.dtype(str(got[k].dtype).removeprefix("torch.")) == \
            w.dtype, k


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_and_roofline_match_reference(kind):
    """``model_flops`` and ``RooflineTerms.dominant`` / ``step_time_s``
    equal the reference's on the same inputs; the terms are reckoned on
    the H100's data-sheet rates, keyed by its ``nvidia-smi`` name."""
    assert H.model_flops(1.5e9, 8192, kind) == \
        ref_analysis.model_flops(1.5e9, 8192, kind)
    for terms in ((3e-3, 1e-3, 2e-3), (1e-3, 5e-3, 0.0), (0.0, 1e-4, 2e-3)):
        got = H.RooflineTerms(*terms, 1.0, 2.0, 3.0, 8)
        want = ref_analysis.RooflineTerms(*terms, 1.0, 2.0, 3.0, 8)
        assert (got.dominant, got.step_time_s) == \
            (want.dominant, want.step_time_s)
        assert got.to_dict() == want.to_dict()
    card = H.CARDS["NVIDIA H100 80GB HBM3"]
    r = H.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12},
                         {"total_coll_bytes": 0}, 1)
    assert card is H.H100 and r.compute_s == 1.0 and r.memory_s == 1.0
    c = to_cost({"flops": 0, "dot_flops": 0, "bytes": 0,
                 **{f"coll_{f}/{k}": 0 for f in ("bytes", "counts")
                    for k in ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all", "collective-permute")},
                 "coll_bytes/p2p": 900e9, "coll_counts/p2p": 2})
    assert H.roofline_terms({}, c, 1).collective_s == 2.0


def test_argument_bytes_are_state_plus_inputs(monkeypatch):
    """A training cell's argument bytes are its float32 parameters, the
    AdamW moments and step, and its inputs; a decode cell's the bf16
    parameters, the cache (also the donated bytes) and its inputs."""
    monkeypatch.setattr(D, "SHAPES", _SMOKE_SHAPES)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta", spoof=4)
    cfg = get_smoke_config("mixtral_8x7b")
    bundle = build_model(cfg)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    p32 = nbytes(bundle.abstract_params(torch.float32))
    train, _ = D.lower_cell("mixtral_8x7b", "train_4k", mesh, cfg=cfg,
                            full_depth=True)
    inputs = nbytes(bundle.input_specs(_SMOKE_SHAPES["train_4k"])[0])
    assert train.tally["argument_bytes"] == 3 * p32 + 4 + inputs
    assert train.tally["alias_bytes"] == 3 * p32 + 4
    dec, _ = D.lower_cell("mixtral_8x7b", "decode_32k", mesh, "sp", "sp",
                          cfg=cfg, full_depth=True)
    cache = nbytes(bundle.cache_spec(2, 32)[0])
    assert dec.tally["argument_bytes"] == p32 // 2 + cache + 2 * 4 + 4
    assert dec.tally["alias_bytes"] == cache


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_temp_is_the_live_peak_of_a_chain(device):
    """The peak of live bytes outside the arguments, on a chain whose peak
    is counted by hand: ``a`` and ``b`` live together (2 x 4096 bytes),
    then ``a`` is freed before ``c``, the sum's 4 bytes; a view adds
    nothing and an in-place op on an argument adds nothing."""
    x = torch.zeros(1024, device=device)
    with CostCounter(arguments=(x,)) as c:
        x.add_(1.0)
        a = x * 2.0
        b = a + 1.0
        v = b.view(32, 32)
        del a
        s = v.sum()
        assert c.live == 4096 + 4
        del b, v
        assert c.live == 4
    t = c.tally()
    assert t["temp_bytes"] == 2 * 4096 and t["argument_bytes"] == 4096
    assert t["flops"] == 1024 * 3 + 1024
    # add_, mul and add each read 4096 bytes and write 4096 (a Python
    # scalar is no tensor); the view is free; sum reads 4096, writes 4
    assert t["bytes"] == 3 * 2 * 4096 + 4096 + 4
    del s


def test_p2p_and_collectives_of_the_meshed_moe():
    """One meshed MoE on a spoofed (1, 2) meta mesh (EP, one expert a
    shard): shard 1 receives its token slice, the router and its expert
    slices (five p2p copies; shard 0 copies nothing to itself), and the
    mesh does two psums: ``y`` over both shards (``[t, d]`` float32) and
    the load-balance estimate over the one batch shard."""
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x7b"), n_experts=2,
                              top_k=1)
    bundle = build_model(cfg)
    lp = {k: v[0] for k, v in bundle.abstract_params(
        torch.bfloat16)["layers"].items()}
    x = torch.empty(2, 8, cfg.d_model, dtype=torch.bfloat16, device="meta")
    mesh = make_mesh((1, 2), ("data", "model"), device="meta", spoof=2)
    with CostCounter(arguments=(x, lp)) as c:
        moe_ffn_sharded(x, lp, cfg, mesh)
    t = c.tally()

    def nb(u):
        return u.numel() * u.element_size()

    experts = sum(nb(lp[k]) // 2 for k in ("we_gate", "we_up", "we_down"))
    assert t["coll_counts/p2p"] == 5
    assert t["coll_bytes/p2p"] == nb(x) + nb(lp["router"]) + experts
    assert t["coll_counts/all-reduce"] == 2 + 1
    assert t["coll_bytes/all-reduce"] == 2 * 16 * cfg.d_model * 4 + 4
    cost = to_cost(t, n_devices=2)
    assert cost.coll_counts["all-reduce"] == 1.5
    assert cost.coll_bytes["p2p"] == t["coll_bytes/p2p"] / 2


def test_meta_device_and_production_meshes():
    """``"meta"`` is a device only when named: the production meshes build
    spoofed on it, and ``"cuda"`` without a card still raises."""
    assert resolve_device("meta").type == "meta"
    assert len(mesh_devices(device="meta", spoof=256)) == 256
    pod = make_production_mesh(device="meta", spoof=256)
    multi = make_production_mesh(multi_pod=True, device="meta", spoof=512)
    assert pod.dims == (16, 16) and multi.dims == (2, 16, 16)
    assert multi.axis_names == ("pod", "data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


_REF_KEYS = {"arch", "shape", "kind", "mesh", "rules", "attn", "compile_s",
             "cost_analysis_raw", "loop_aware", "collectives", "memory",
             "roofline"}


def test_run_cell_writes_reference_keys(smoke_internlm2, tmp_path, capsys):
    """``run_cell`` and the CLI write the reference's JSON keys under the
    reference's path layout: ``<out>/pod/<arch>_<shape>.json``, with a
    ``_<rules>_<attn>`` suffix when those are given."""
    rec = D.run_cell("internlm2_1_8b", "train_4k", False, str(tmp_path))
    path = tmp_path / "pod" / "internlm2_1_8b_train_4k.json"
    on_disk = json.loads(path.read_text())
    assert _REF_KEYS <= on_disk.keys() and on_disk["mesh"] == [16, 16]
    assert on_disk["loop_aware"] == rec["loop_aware"]
    assert set(on_disk["loop_aware"]) == {"flops", "dot_flops", "bytes"}
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"} <= \
        on_disk["memory"].keys()
    assert {"compute_s", "memory_s", "collective_s", "hlo_flops",
            "hlo_bytes", "coll_bytes", "n_devices", "dominant",
            "step_time_s"} <= on_disk["roofline"].keys()
    r = on_disk["roofline"]
    assert r["n_devices"] == 256
    assert math.isclose(r["hlo_flops"] * 256, on_disk["loop_aware"]["flops"])
    assert set(on_disk["collectives"]["bytes"]) >= {"all-reduce", "p2p"}
    D.main(["--arch", "internlm2_1_8b", "--shape", "train_4k", "--rules",
            "base", "--out", str(tmp_path)])
    assert (tmp_path / "pod" / "internlm2_1_8b_train_4k_base_baseline.json"
            ).exists()
    assert "[dryrun OK]" in capsys.readouterr().out
