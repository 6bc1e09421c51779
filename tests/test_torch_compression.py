"""Synapse compression in the port (value dedup, the shared dictionary,
execution through the indirection): twin of ``tests/test_compression.py``.

Each test builds the same seeded weights in both packages, asserts the
reference test's own assertions on the port, and holds the port's tables,
accounting and results equal to the reference's.  Everything is exact:
tables and counts equal, spikes and every stat bit for bit (the engine on
both CPU routes against the reference's numpy oracle ``run_batch``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import assert_batched_equals_oracle
from repro.core.accelerator import map_model as ref_map_model
from repro.core.accelerator import run_batch as ref_run_batch
from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.layers import Conv2d as RefConv2d
from repro.core.layers import Dense as RefDense
from repro.core.mapping import MappingProblem as RefProblem
from repro.core.mapping import autotune_grid as ref_autotune_grid
from repro.core.mapping import solve_mapping as ref_solve
from repro.core.memories import build_event_memories as ref_build
from repro.core.memories import compress_weight_words as ref_compress

from repro_torch.core.accelerator import map_model
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.layers import Conv2d, Dense
from repro_torch.core.mapping import (MappingProblem, autotune_grid,
                                      solve_mapping)
from repro_torch.core.memories import (build_event_memories,
                                       compress_weight_words)
from repro_torch.core.noise import AnalogNoise, perturb_packed
from repro_torch.engine import run_batched

torch.set_num_threads(1)

SPEC_ARGS = dict(n_cores=3, n_engines=4, n_caps=8, weight_mem_bytes=1 << 20)
SPEC = AcceleratorSpec("comp", **SPEC_ARGS)
REF_SPEC = RefSpec("comp", **SPEC_ARGS)
ROUTES = (False, True)          # packed_ops


def _weights(rng, n_src=10, n_dest=14, repeated_values=True):
    """The reference's ``_mapped_tables`` draws."""
    w = rng.normal(size=(n_src, n_dest)).astype(np.float32)
    w[rng.random(w.shape) > 0.5] = 0
    if repeated_values:
        w = np.round(w * 4) / 4
    return w


def _tables(w, dedup=False):
    """``(reference tables, port tables)`` of ``w`` on SPEC's grid."""
    m, n = SPEC.n_engines, SPEC.n_caps
    ref = ref_build(w, ref_solve(RefProblem.from_weights(w, m, n)), m, n,
                    dedup=dedup)
    port = build_event_memories(
        w, solve_mapping(MappingProblem.from_weights(w, m, n)), m, n,
        dedup=dedup)
    return ref, port


def _assert_tables_equal(port, ref):
    for f in ("e2a_addr", "e2a_count", "sn_valid", "sn_virt", "sn_waddr",
              "weight_mem", "weight_ptr", "weight_dict"):
        a, b = getattr(port, f, None), getattr(ref, f, None)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert port.n_weight_words == ref.n_weight_words
    np.testing.assert_array_equal(port.alloc_words(), ref.alloc_words())


def test_dedup_shrinks_words_replay_unchanged():
    """Value dedup allocates fewer A-SYN words while replaying the exact
    same dense effective-weight matrix; both tables equal the
    reference's."""
    w = _weights(np.random.default_rng(7))
    ref_plain, plain = _tables(w)
    ref_dedup, deduped = _tables(w, dedup=True)
    n_dest = w.shape[1]
    np.testing.assert_array_equal(plain.dense_weights(n_dest),
                                  deduped.dense_weights(n_dest))
    assert deduped.n_weight_words < plain.n_weight_words
    assert (deduped.alloc_words() <= plain.alloc_words()).all()
    _assert_tables_equal(plain, ref_plain)
    _assert_tables_equal(deduped, ref_dedup)
    np.testing.assert_array_equal(deduped.dense_weights(n_dest),
                                  ref_dedup.dense_weights(n_dest))


def test_dict_ptr_invariant_and_accounting():
    """After ``compress_weight_words``, ``weight_dict[weight_ptr] ==
    weight_mem`` on every allocated slot, the per-table new-word counts sum
    to the dictionary size, and the accounting equals the reference's."""
    pairs = [_tables(_weights(np.random.default_rng(seed)), dedup=True)
             for seed in range(3)]
    ref_stats = ref_compress([r for r, _ in pairs])
    tabs = [p for _, p in pairs]
    stats = compress_weight_words(tabs)
    assert stats.dict_words == sum(tb.n_weight_words for tb in tabs)
    assert stats.dict_words <= stats.slot_words <= stats.synapse_words
    assert stats.ratio >= 1.0
    assert stats.compressed_bytes == stats.dict_bytes + stats.ptr_bytes
    for tb in tabs:
        words = tb.alloc_words()
        for j in range(tb.n_engines):
            a = int(words[j])
            np.testing.assert_array_equal(
                tb.weight_dict[tb.weight_ptr[j, :a]], tb.weight_mem[j, :a])
    assert stats.as_dict() == ref_stats.as_dict()
    for r, p in pairs:
        _assert_tables_equal(p, r)


def test_replay_coo_ptr_matches_replay_coo():
    ref, tb = _tables(_weights(np.random.default_rng(11)), dedup=True)
    ref_compress([ref])
    compress_weight_words([tb])
    src, dest, vals = tb.replay_coo()
    src2, dest2, widx = tb.replay_coo_ptr()
    np.testing.assert_array_equal(src, src2)
    np.testing.assert_array_equal(dest, dest2)
    np.testing.assert_array_equal(tb.weight_dict[widx], vals)
    for got, want in zip(tb.replay_coo_ptr(), ref.replay_coo_ptr()):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_replay_coo_ptr_requires_compression():
    ref, tb = _tables(_weights(np.random.default_rng(12)))
    for t in (tb, ref):
        with pytest.raises(ValueError, match="not compressed"):
            t.replay_coo_ptr()


def _stack(rng, conv=Conv2d, dense=Dense):
    """The reference's ``_stack``, with either package's layer classes."""
    k = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    k[rng.random(k.shape) > 0.7] = 0
    c = conv(kernel=k, in_shape=(2, 6, 6), padding=1)
    w1 = rng.normal(size=(c.n_dest, 20)).astype(np.float32)
    w1[rng.random(w1.shape) > 0.4] = 0
    w2 = rng.normal(size=(20, 5)).astype(np.float32)
    return [c, dense(w=w1), dense(w=w2)]


def _engine_equals_oracle(port_model, ref_model, spikes, max_events=None,
                          ctx=""):
    oracle = ref_run_batch(ref_model, spikes, max_events=max_events)
    for packed_ops in ROUTES:
        res = run_batched(port_model.pack(device="cpu",
                                          packed_ops=packed_ops),
                          spikes, max_events=max_events)
        assert_batched_equals_oracle(res, oracle, len(port_model.layers),
                                     f"{ctx} packed_ops={packed_ops}")


def test_compressed_model_shrinks_sram_bit_exact():
    """``compress=True`` shrinks every layer's ``sram_bytes`` (as the
    reference's does, to the same bytes), fills the compression report,
    and changes nothing about the spikes: compressed against uncompressed
    on both routes, and the compressed model against the reference's
    oracle, uncapped and at ``max_events=4``."""
    m0 = map_model(_stack(np.random.default_rng(21)), SPEC)
    m1 = map_model(_stack(np.random.default_rng(21)), SPEC, compress=True)
    ref1 = ref_map_model(_stack(np.random.default_rng(21), RefConv2d,
                                RefDense), REF_SPEC, compress=True)
    assert m1.compression is not None and m1.weight_dict is not None
    assert m1.compression.ratio > 1.0
    assert sum(l.sram_bytes for l in m1.layers) == m1.compression.dict_words
    for l0, l1 in zip(m0.layers, m1.layers):
        assert l1.sram_bytes <= l0.sram_bytes
    assert [l.sram_bytes for l in m1.layers] == \
        [l.sram_bytes for l in ref1.layers]
    assert m1.compression.as_dict() == ref1.compression.as_dict()
    rng2 = np.random.default_rng(5)
    spikes = (rng2.random((3, 5, m0.layers[0].n_src)) < 0.25
              ).astype(np.float32)
    for packed_ops in ROUTES:
        r0 = run_batched(m0.pack(device="cpu", packed_ops=packed_ops),
                         spikes)
        r1 = run_batched(m1.pack(device="cpu", packed_ops=packed_ops),
                         spikes)
        np.testing.assert_array_equal(r0.out_spikes, r1.out_spikes)
    _engine_equals_oracle(m1, ref1, spikes, ctx="compressed")
    _engine_equals_oracle(m1, ref1, spikes, max_events=4,
                          ctx="compressed-capped")


def test_noise_on_compressed_equals_uncompressed_conv():
    """Analog mismatch is per physical synapse, not per dictionary entry:
    perturbing a compressed conv model equals perturbing the uncompressed
    one (same seed, same fused tile).  The port draws its own noise (the
    reference's comes from JAX keys), so the noisy spikes are held to each
    other, and the noiseless model to the reference's oracle; sigma 0
    stays the identity."""
    k = np.random.default_rng(31).normal(size=(2, 1, 3, 3)).astype(np.float32)
    m0 = map_model([Conv2d(kernel=k, in_shape=(1, 6, 6))], SPEC)
    m1 = map_model([Conv2d(kernel=k, in_shape=(1, 6, 6))], SPEC,
                   compress=True)
    ref1 = ref_map_model([RefConv2d(kernel=k, in_shape=(1, 6, 6))],
                         REF_SPEC, compress=True)
    noise = AnalogNoise(weight_sigma=0.08)
    p0 = perturb_packed(9, m0.pack(device="cpu"), noise)
    p1 = perturb_packed(9, m1.pack(device="cpu"), noise)
    spikes = (np.random.default_rng(3).random((2, 4, m0.layers[0].n_src))
              < 0.3).astype(np.float32)
    r0 = run_batched(p0, spikes, with_stats=False)
    r1 = run_batched(p1, spikes, with_stats=False)
    np.testing.assert_array_equal(r0.out_spikes, r1.out_spikes)
    for a, b in zip(p0.layers, p1.layers):
        np.testing.assert_array_equal(a.w_fused.numpy(), b.w_fused.numpy())
    assert perturb_packed(9, m1.pack(device="cpu"),
                          AnalogNoise(weight_sigma=0.0)) is m1.pack(
                              device="cpu")
    _engine_equals_oracle(m1, ref1, spikes, ctx="noiseless")


def test_autotuned_compressed_model_equivalent():
    """The autotuner's compressed model (the grid the reference chooses,
    ``tests/test_torch_autotune_experts.py`` holds the scores) satisfies
    the full contract on both routes against the reference's oracle on
    the reference's autotuned model."""
    res = autotune_grid(_stack(np.random.default_rng(41)), SPEC,
                        compress=True)
    ref = ref_autotune_grid(_stack(np.random.default_rng(41), RefConv2d,
                                   RefDense), REF_SPEC, compress=True)
    assert res.best.rounds_per_timestep <= res.default.rounds_per_timestep
    assert dataclasses.astuple(res.best) == dataclasses.astuple(ref.best)
    spikes = (np.random.default_rng(6).random(
        (2, 4, res.model.layers[0].n_src)) < 0.2).astype(np.float32)
    _engine_equals_oracle(res.model, ref.model, spikes, ctx="autotuned")
