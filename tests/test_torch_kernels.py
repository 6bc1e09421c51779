"""The port's kernel modules against the reference package's kernels.

On the CPU every kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions to ``repro.kernels.ref`` (allclose, atol 1e-5, as
tests/test_kernels.py does) and, where the reference promises it, bit for
bit to the reference's Pallas kernels in interpret mode and to the numpy
oracle.  The hand-written CUDA kernels are held to the plain versions in
tests/test_torch_cuda.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accelerator import lif_rollout_np
from repro.core.lif import LIFParams as RefLIF
from repro.core.quant import pack_signmag as ref_pack_signmag
from repro.core.quant import quantize_symmetric as ref_quantize
from repro.core.quant import unpack_signmag as ref_unpack_signmag
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.event_synapse import _events_from_spikes_argsort

from repro_torch.core.lif import LIFParams
from repro_torch.core.quant import (pack_signmag, quantize_symmetric,
                                    unpack_signmag)
from repro_torch.kernels import event_synapse as es
from repro_torch.kernels import lif_update as lu
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _codes(rng, n_src, n_dest, bits):
    qmax = 2 ** (bits - 1) - 1
    return rng.integers(-qmax, qmax + 1, (n_src, n_dest)).astype(np.int8)


# ------------------------------------------------------------ event_synapse

@pytest.mark.parametrize("n_src,n_dest,p", [
    (16, 128, 0.3), (40, 512, 0.5), (100, 256, 0.1), (7, 384, 0.9),
])
def test_event_synapse_plain_matches_reference(n_src, n_dest, p):
    rng = np.random.default_rng(n_src)
    w = rng.normal(size=(n_src, n_dest)).astype(np.float32)
    spikes = (rng.random((3, n_src)) < p).astype(np.float32)
    ev = ops.events_from_spikes(_t(spikes), n_src)
    out = ops.event_synapse(ev, _t(w))
    want = ref_ref.event_synapse_ref(jnp.asarray(ev.numpy()), jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    # ascending sequential float32 adds: the oracle's order, bit for bit
    seq = np.zeros((3, n_dest), np.float32)
    for r in range(3):
        for s in np.nonzero(spikes[r])[0]:
            seq[r] += w[s]
    np.testing.assert_array_equal(out.numpy(), seq)


def test_event_synapse_all_padding_and_empty():
    w = torch.ones(8, 128)
    assert torch.equal(ops.event_synapse(torch.full((2, 4), -1,
                                                    dtype=torch.int32), w),
                       torch.zeros(2, 128))
    assert ops.event_synapse(torch.zeros(0, 4, dtype=torch.int32),
                             w).shape == (0, 128)
    assert torch.equal(ops.event_synapse(torch.zeros(3, 0, dtype=torch.int32),
                                         w), torch.zeros(3, 128))


@pytest.mark.parametrize("max_ev", [1, 5, 16, 40, 64])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_events_from_spikes_matches_reference(max_ev, p):
    """Same events, same order, same padding and clamp as the reference's
    MEM_E writer and its argsort twin, including under truncation."""
    rng = np.random.default_rng(max_ev)
    spikes = (rng.random((4, 40)) < p).astype(np.float32)
    ev = ops.events_from_spikes(_t(spikes), max_ev)
    assert ev.dtype == torch.int32
    want = ref_ops.events_from_spikes(jnp.asarray(spikes), max_ev)
    np.testing.assert_array_equal(ev.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ev.numpy(),
        np.asarray(_events_from_spikes_argsort(jnp.asarray(spikes),
                                               min(max_ev, 40))))
    np.testing.assert_array_equal(
        ops.overflow_count(_t(spikes), max_ev).numpy(),
        np.asarray(ref_ops.overflow_count(jnp.asarray(spikes), max_ev)))


# ----------------------------------------------------- event_synapse_packed

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_event_synapse_packed_matches_reference(bits):
    """Plain packed == reference packed oracle (allclose), == the
    reference's packed Pallas kernel in interpret mode (bit-exact), and ==
    the dense plain version on the dequantized tile (bit-exact)."""
    rng = np.random.default_rng(bits)
    q = _codes(rng, 24, 128, bits)
    packed = pack_signmag(q, bits)
    np.testing.assert_array_equal(packed, ref_pack_signmag(q, bits))
    scale = np.float32(0.013)
    spikes = (rng.random((4, 24)) < 0.4).astype(np.float32)
    ev = ops.events_from_spikes(_t(spikes), 24)
    out = ops.event_synapse_packed(ev, _t(packed), scale, bits=bits)
    jev, jpk = jnp.asarray(ev.numpy()), jnp.asarray(packed)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(ref_ref.event_synapse_packed_ref(jev, jpk, scale, bits)),
        atol=1e-5)
    np.testing.assert_array_equal(
        out.numpy(),
        np.asarray(ref_ops.event_synapse_packed(jev, jpk, scale, bits=bits)))
    dense = ops.event_synapse(ev, _t(q.astype(np.float32) * scale))
    np.testing.assert_array_equal(out.numpy(), dense.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_signmag_matches_reference(bits):
    rng = np.random.default_rng(10 + bits)
    q = _codes(rng, 5, 16, bits)
    packed = pack_signmag(q, bits)
    want = np.asarray(ref_unpack_signmag(packed, bits))
    np.testing.assert_array_equal(unpack_signmag(packed, bits), want)
    np.testing.assert_array_equal(unpack_signmag(_t(packed), bits).numpy(),
                                  want)
    np.testing.assert_array_equal(want, q)


def test_packed_rejects_bad_bits():
    ev = torch.full((1, 2), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.event_synapse_packed(ev, torch.zeros(8, 32, dtype=torch.int8),
                                 0.1, bits=3)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_symmetric_matches_reference(bits, dtype):
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 0.3, (17, 9)).astype(dtype)
    w[rng.random(w.shape) < 0.4] = 0
    got, want = quantize_symmetric(w, bits=bits), ref_quantize(w, bits=bits)
    np.testing.assert_array_equal(got.q, np.asarray(want.q))
    np.testing.assert_array_equal(got.scale, np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize(),
                                  np.asarray(want.dequantize()))


# ---------------------------------------------------------------- lif_update

@pytest.mark.parametrize("beta,threshold,v_reset", [
    (0.9, 1.0, 0.0), (0.85, 0.7, 0.1), (0.8, 0.7, 0.0),
])
def test_lif_update_matches_reference_kernel(beta, threshold, v_reset):
    """Single step: bit-exact with the reference's jnp oracle (separately
    rounded ``beta * v`` and ``+ I``, like the numpy oracle), and within the
    reference suite's own atol 1e-6 of its Pallas lif_update in interpret
    mode, which XLA on the CPU contracts into a fused multiply-add."""
    rng = np.random.default_rng(1)
    v = rng.normal(0.5, 0.6, (4, 256)).astype(np.float32)
    i = rng.normal(0.3, 0.6, (4, 256)).astype(np.float32)
    vn, s = ops.lif_update(_t(v), _t(i), beta=beta, threshold=threshold,
                           v_reset=v_reset)
    vk, sk = ref_ops.lif_update(jnp.asarray(v), jnp.asarray(i), beta=beta,
                                threshold=threshold, v_reset=v_reset,
                                block=(4, 256))
    np.testing.assert_allclose(vn.numpy(), np.asarray(vk), atol=1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sk))
    vr, sr = ref_ref.lif_update_ref(jnp.asarray(v), jnp.asarray(i), beta,
                                    threshold, v_reset)
    np.testing.assert_array_equal(vn.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("shape", [(3, 7, 33), (2, 1, 10), (1, 25, 64)])
def test_lif_scan_matches_oracle(shape):
    """Time-loop form == the numpy oracle's lif_rollout_np, bit for bit."""
    rng = np.random.default_rng(shape[1])
    cur = rng.normal(0.4, 0.7, shape).astype(np.float32)
    p = LIFParams(beta=0.85, threshold=0.7, v_reset=0.1)
    got = ops.lif_scan(_t(cur), p).numpy()
    for b in range(shape[0]):
        want = lif_rollout_np(cur[b], RefLIF(beta=0.85, threshold=0.7,
                                             v_reset=0.1))
        np.testing.assert_array_equal(got[b], want)


def test_ref_names_are_the_plain_versions():
    assert ref.event_synapse_ref is es.event_synapse_plain
    assert ref.event_synapse_packed_ref is es.event_synapse_packed_plain
    assert ref.lif_update_ref is lu.lif_update_plain
    assert ref.lif_scan_ref is lu.lif_scan_plain


def test_launchers_refuse_cpu_tensors():
    """The CUDA launchers never take a CPU tensor (the wrappers send those
    to the plain versions), and a device other than cpu/cuda raises."""
    ev = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        es.event_synapse_cuda(ev, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        lu.lif_scan_cuda(torch.zeros(1, 2, 3), LIFParams())
    with pytest.raises(ValueError, match="unsupported device"):
        ops.event_synapse(ev.to("meta"), torch.zeros(4, 8, device="meta"))


def test_core_lif_rollout_matches_reference():
    """core.lif forward: spikes equal the reference's ``lax.scan`` rollout,
    and the voltage trace equals the numpy oracle's arithmetic bit for bit
    (the reference's scan, compiled by XLA on the CPU, fuses ``beta*v + I``
    and so sits within atol 1e-6 of it)."""
    from repro.core.lif import lif_rollout as ref_rollout

    from repro_torch.core.lif import lif_rollout
    rng = np.random.default_rng(2)
    cur = rng.normal(0.4, 0.7, (12, 3, 40)).astype(np.float32)
    s, v = lif_rollout(_t(cur), LIFParams(beta=0.85, threshold=0.7,
                                          v_reset=0.1))
    rs, rv = ref_rollout(jnp.asarray(cur), RefLIF(beta=0.85, threshold=0.7,
                                                  v_reset=0.1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-6)
    vn = np.zeros_like(cur[0])
    for t in range(cur.shape[0]):
        vn = np.float32(0.85) * vn + cur[t]
        vn = np.where(vn >= np.float32(0.7), np.float32(0.1), vn)
        np.testing.assert_array_equal(v[t].numpy(), vn)


# ---------------------------------------------------------------- c2c_matmul

@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (128, 256, 384, 128, 128, 128),
    (64, 128, 128, 64, 64, 128),
    (256, 512, 256, 128, 256, 128),
])
def test_c2c_matmul_matches_reference_kernel(m, k, n, bm, bk, bn):
    """The port's c2c_matmul (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, at the reference suite's
    shapes and tolerance."""
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    out = ops.c2c_matmul(_t(x), _t(wq), 0.02)
    want = ref_ops.c2c_matmul(jnp.asarray(x), jnp.asarray(wq),
                              jnp.float32(0.02), bm=bm, bk=bk, bn=bn)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(
        ref.c2c_matmul_ref(_t(x), _t(wq), 0.02).numpy(),
        np.asarray(ref_ref.c2c_matmul_ref(jnp.asarray(x), jnp.asarray(wq),
                                          jnp.float32(0.02))),
        rtol=1e-4, atol=1e-3)


def test_c2c_matmul_equals_ideal_ladder():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(128, 128)).astype(np.int8)
    out = ops.c2c_matmul(_t(x), _t(wq), 0.013)
    ladder = ref.c2c_matmul_ladder_ref(_t(x), _t(wq), 0.013)
    np.testing.assert_allclose(out.numpy(), ladder.numpy(), rtol=1e-4,
                               atol=1e-3)
    want = ref_ref.c2c_matmul_ladder_ref(jnp.asarray(x), jnp.asarray(wq),
                                         jnp.float32(0.013))
    np.testing.assert_allclose(ladder.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_c2c_matmul_int8_extremes():
    x = torch.ones(8, 128)
    wq = torch.full((128, 128), -128, dtype=torch.int8)
    out = ops.c2c_matmul(x, wq, 1.0)
    np.testing.assert_allclose(out.numpy(), (x @ wq.float()).numpy(),
                               rtol=1e-5)
    want = ref_ops.c2c_matmul(jnp.ones((8, 128), jnp.float32),
                              jnp.full((128, 128), -128, jnp.int8),
                              jnp.float32(1.0), bm=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_c2c_ladder_value_bit_exact(bits):
    """Every code of the width, and -128 at 8 bits (outside the ladder:
    it reads as -0.0), bit for bit with the reference."""
    from repro.core.quant import c2c_ladder_value as ref_ladder

    from repro_torch.core.quant import c2c_ladder_value
    lo = -128 if bits == 8 else -(2 ** (bits - 1) - 1)
    q = np.arange(lo, 2 ** (bits - 1)).astype(np.int8)
    want = np.asarray(ref_ladder(jnp.asarray(q), bits=bits))
    for got in (c2c_ladder_value(q, bits=bits),
                c2c_ladder_value(_t(q), bits=bits).numpy()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_c2c_names_and_launcher_refuse_cpu():
    from repro_torch.kernels import c2c_matmul as c2c
    assert ref.c2c_matmul_plain is c2c.c2c_matmul_plain
    with pytest.raises(ValueError, match="CUDA"):
        c2c.c2c_matmul_cuda(torch.zeros(2, 3),
                            torch.zeros(3, 4, dtype=torch.int8), 1.0)
    splits, chunk = c2c._splits(128, 32768, 1024, 132)
    assert splits * chunk >= 32768 > (splits - 1) * chunk
    assert chunk % c2c.BK == 0 and c2c._splits(64, 100, 64, 132)[0] == 1
