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


@pytest.mark.parametrize("max_ev", [1, 7, 64, 299, 300, 1000])
@pytest.mark.parametrize("seed", range(3))
def test_events_from_spikes_rows_ascending_valid_prefix(seed, max_ev):
    """The contract the dense CUDA kernel walks by: every row of the MEM_E
    writer's output is a strictly ascending prefix of valid sources (the
    row's first ``max_events`` spikes) followed only by -1, and equals the
    reference's writer."""
    rng = np.random.default_rng(seed)
    p = rng.choice([0.01, 0.06, 0.3, 0.9], size=(8, 1))
    spikes = (rng.random((8, 300)) < p).astype(np.float32)
    spikes[2] = 0
    spikes[5] = 1
    ev = ops.events_from_spikes(_t(spikes), max_ev).numpy()
    assert ev.shape == (8, min(max_ev, 300))
    for row, sp in zip(ev, spikes):
        n = int((row >= 0).sum())
        assert (row[n:] == -1).all()
        assert (np.diff(row[:n]) > 0).all()
        np.testing.assert_array_equal(row[:n], np.flatnonzero(sp)[:max_ev])
    np.testing.assert_array_equal(
        ev, np.asarray(ref_ops.events_from_spikes(jnp.asarray(spikes),
                                                  max_ev)))


# --------------------------------------------- event lists in any layout

def _lists(layout, rng, n_rows, n_src, width):
    """Event lists ``[n_rows, width]`` in a layout the reference takes:
    ``interior`` (ascending sources with -1 between and around them),
    ``unsorted`` (sources in random order, repeats allowed, -1 anywhere) or
    ``all_padding`` (every row -1); row 0 is all -1 in every layout, and
    row 1 is the list ``[3, -1, 5, -1, ...]``."""
    ev = np.full((n_rows, width), -1, np.int32)
    if layout != "all_padding":
        for r in range(2, n_rows):
            k = int(rng.integers(1, width // 2 + 1))
            pos = np.sort(rng.choice(width, k, replace=False))
            if layout == "interior":
                src = np.sort(rng.choice(n_src, k, replace=False))
            else:
                src = rng.integers(0, n_src, k)
            ev[r, pos] = src
        ev[1, [0, 2]] = (3, 5)
    return ev


def _list_order_sum(ev, w):
    """numpy: each row's valid entries, one float32 add each in list
    order."""
    out = np.zeros((ev.shape[0], w.shape[1]), np.float32)
    for r, row in enumerate(ev):
        for s in row:
            if s >= 0:
                out[r] += w[s]
    return out


@pytest.mark.parametrize("layout", ["interior", "unsorted", "all_padding"])
def test_event_synapse_any_layout_matches_reference(layout):
    """The dense plain version adds every entry >= 0 in list order,
    wherever a -1 sits, as the reference does: bit for bit against a numpy
    sequential float32 sum in list order, and within the reference suite's
    atol 1e-5 of ``repro.kernels.ref.event_synapse_ref`` (a reduction in
    another order; the Pallas dense kernel cannot trace on this JAX)."""
    rng = np.random.default_rng(21)
    w = rng.normal(size=(40, 96)).astype(np.float32)
    ev = _lists(layout, rng, 9, 40, 12)
    out = ops.event_synapse(_t(ev), _t(w)).numpy()
    np.testing.assert_array_equal(out, _list_order_sum(ev, w))
    np.testing.assert_allclose(
        out, np.asarray(ref_ref.event_synapse_ref(jnp.asarray(ev),
                                                  jnp.asarray(w))),
        atol=1e-5)
    if layout != "all_padding":
        np.testing.assert_array_equal(out[1], w[3] + w[5])


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("layout", ["interior", "unsorted", "all_padding"])
def test_event_synapse_packed_any_layout_matches_pallas(layout, bits):
    """The packed plain version on lists with interior -1s, all -1 rows
    and unsorted rows equals the reference's Pallas
    ``event_synapse_packed`` in interpret mode bit for bit."""
    rng = np.random.default_rng(30 + bits)
    q = _codes(rng, 40, 128, bits)
    packed = pack_signmag(q, bits)
    scale = np.float32(0.021)
    ev = _lists(layout, rng, 9, 40, 12)
    out = ops.event_synapse_packed(_t(ev), _t(packed), scale, bits=bits)
    want = ref_ops.event_synapse_packed(jnp.asarray(ev), jnp.asarray(packed),
                                        scale, bits=bits)
    assert torch.equal(out, _t(np.array(want)))
    np.testing.assert_array_equal(
        out.numpy(), _list_order_sum(ev, q.astype(np.float32) * scale))


@pytest.mark.parametrize("seed", range(3))
def test_compact_events_keeps_list_order(seed):
    """The CUDA launchers' compaction: each row's valid entries to the
    front in list order, -1 after them, as a view with contiguous rows;
    the kernel's sum over it equals the plain sum over the original list
    bit for bit."""
    rng = np.random.default_rng(seed)
    ev = _lists("interior", rng, 12, 300, 40)
    got = es.compact_events(_t(ev))
    assert got.shape == ev.shape and got.stride(1) == 1
    for row, want in zip(got.numpy(), ev):
        valid = want[want >= 0]
        np.testing.assert_array_equal(row[:valid.size], valid)
        assert (row[valid.size:] == -1).all()
    w = _t(rng.normal(size=(300, 64)).astype(np.float32))
    assert torch.equal(es.event_synapse_plain(got, w),
                       es.event_synapse_plain(_t(ev), w))


def test_kernel_events_rejects_lists_the_kernel_cannot_take():
    """What the CUDA launchers hand the kernel: interior -1s compacted
    away, ``compacted=True`` passed through untouched, and a row that does
    not ascend strictly (unsorted, or a repeat) or holds a source past the
    tile refused with ValueError naming the contract."""
    ev = _t(np.array([[3, -1, 5, -1], [-1, -1, -1, 7], [-1] * 4], np.int32))
    got = es._kernel_events(ev, 8, compacted=False)
    np.testing.assert_array_equal(
        got.numpy(), [[3, 5, -1, -1], [7, -1, -1, -1], [-1] * 4])
    assert es._kernel_events(ev, 8, compacted=True) is ev
    for bad in ([[5, 3, -1]], [[2, 2, -1]], [[1, -1, 0]]):
        with pytest.raises(ValueError, match="ascending"):
            es._kernel_events(_t(np.array(bad, np.int32)), 8, False)
    with pytest.raises(ValueError, match="n_src"):
        es._kernel_events(_t(np.array([[1, 8]], np.int32)), 8, False)


def test_scale_arg_reads_no_device():
    """The packed launcher takes a host number by value and a CPU tensor
    read on the host; only a CUDA tensor goes to the kernel by pointer."""
    for scale in (0.013, np.float32(0.013), torch.tensor([[0.013]])):
        value, on_device = es._scale_arg(scale, torch.device("cpu"))
        assert on_device is None and value == float(np.float32(0.013))


def test_forward_hands_the_packed_launcher_a_host_scale(monkeypatch):
    """The engine's forward gives ``ops.event_synapse_packed`` each layer's
    scale as a host float32 (never a tensor, which the CUDA launcher would
    have to read back from the card) and its compacted MEM_E lists with
    ``compacted=True``; the dense route gets ``compacted=True`` too, and
    both routes give the same spikes."""
    from repro_torch.core.accelerator import map_model
    from repro_torch.core.energy import AcceleratorSpec
    from repro_torch.engine import batched_run as br

    rng = np.random.default_rng(5)
    sizes = (48, 32, 10)
    ws = [rng.normal(0, 1.2 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    mapped = map_model(ws, AcceleratorSpec("small", n_cores=2, n_engines=8,
                                           n_caps=16,
                                           weight_mem_bytes=64 * 1024),
                       quant_bits=4)
    x = _t((rng.random((2, 6, sizes[0])) < 0.4).astype(np.float32))
    seen = []
    real_packed, real_dense = ops.event_synapse_packed, ops.event_synapse

    def packed_spy(events, packed_w, scale, *, bits, compacted=False):
        seen.append(("packed", type(scale), compacted))
        return real_packed(events, packed_w, scale, bits=bits,
                           compacted=compacted)

    def dense_spy(events, weights, *, compacted=False):
        seen.append(("dense", None, compacted))
        return real_dense(events, weights, compacted=compacted)

    monkeypatch.setattr(ops, "event_synapse_packed", packed_spy)
    monkeypatch.setattr(ops, "event_synapse", dense_spy)
    model = mapped.pack(packed_ops=True, device="cpu")
    for layer in model.layers:
        assert isinstance(layer.scale_host, np.float32)
        assert layer.scale_host == layer.scale.item()
    got = br._forward_impl(model, x, None)
    want = br._forward_impl(mapped.pack(packed_ops=False, device="cpu"), x,
                            None)
    assert seen == [("packed", np.float32, True)] * 2 + \
        [("dense", None, True)] * 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.parametrize("b,n,cols", [
    (8, 1024, 64), (8, 512, 32), (8, 200, 32), (8, 100, 32), (8, 10, 32),
    (4, 1024, 32), (32, 1024, 128), (16, 1024, 128), (1, 1, 32),
])
def test_lif_tile_fills_the_card(b, n, cols):
    """The LIF kernel's column tile on a 132-SM H100: the widest of 128, 64
    and 32 neurons whose grid of ``b * ceil(n / cols)`` blocks covers at
    least 7/8 of the SMs, else the narrowest (the engine's largest buckets
    at n = 1024 take 64 columns: 128 blocks, against 32 before)."""
    assert lu.tile_cols(b, n, 132) == cols


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


@pytest.mark.parametrize("m,k,n,splits", [
    (128, 32768, 1024, 16), (256, 1024, 1024, 8), (129, 4097, 1025, 7),
    (64, 100, 64, 1), (1, 1, 1, 1),
])
def test_c2c_splits_fill_one_wave(m, k, n, splits):
    """K is split over at most one block per SM (the kernel's shared memory
    allows one), each split a whole number of K steps at least MIN_SPLIT_K
    deep, and the splits cover K exactly once."""
    from repro_torch.kernels import c2c_matmul as c2c
    got, chunk = c2c._splits(m, k, n, 132)
    tiles = -(-m // c2c.TILE) * -(-n // c2c.TILE)
    assert got == splits
    assert chunk % c2c.BK == 0 and got * chunk >= k > (got - 1) * chunk
    assert got == 1 or (got * tiles <= 132 and chunk >= c2c.MIN_SPLIT_K)


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero (PTX cvt.rna.tf32.f32), by bit operations."""
    b = np.asarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _c2c_tf32_emulated(x, wq, scale, terms):
    """The tensor-core product with x as ``terms`` TF32 terms (1: x_hi; 2:
    x_hi + x_lo), every product exact and the sum taken in float64 before
    one rounding to float32, then the scale in float32: the split's own
    error, apart from the accumulation's rounding."""
    hi = _tf32_rna(x)
    parts = [hi] if terms == 1 else [hi, _tf32_rna(x - hi)]
    w64 = wq.astype(np.float64)
    acc = sum(p.astype(np.float64) @ w64 for p in parts)
    return acc.astype(np.float32) * np.float32(scale)


def _c2c_bound(x, wq, scale):
    k = x.shape[1]
    return (2 * (k + 1) * 2.0 ** -24) * (np.abs(x.astype(np.float64))
                                         @ np.abs(wq.astype(np.float64))) \
        * abs(scale)


@pytest.mark.parametrize("m,k,n", [(256, 1024, 1024), (8, 32768, 64)])
def test_c2c_two_term_tf32_split_within_summation_bound(m, k, n):
    """The kernel's numeric premise, before any card: x split into two
    TF32 terms times exact int8 codes lies within the tolerance
    ``2 (K + 1) 2**-24 (|x| @ |w_q|) |scale|`` of the plain float32
    product with a wide margin, at the reference benchmark's shape and at
    the CIFAR10-DVS input layer's K."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    plain = ops.c2c_matmul(_t(x), _t(wq), 0.02).numpy()
    err = np.abs(_c2c_tf32_emulated(x, wq, 0.02, terms=2) - plain)
    assert (err / _c2c_bound(x, wq, 0.02)).max() < 0.05


def test_c2c_single_tf32_term_misses_summation_bound():
    """Why x is split: with one TF32 term the error of each product (up to
    2**-11 |x w|) adds up past the tolerance at K = 1024 where the
    roundings share a sign, while the two-term split is exact there."""
    k = 1024
    x = np.full((4, k), 1 + 2.0 ** -12 + 2.0 ** -13, np.float32)
    x[1] *= -1
    wq = np.full((k, 8), 127, np.int8)
    wq[:, 1::2] = -128
    plain = ops.c2c_matmul(_t(x), _t(wq), 0.02).numpy()
    bound = _c2c_bound(x, wq, 0.02)
    one = np.abs(_c2c_tf32_emulated(x, wq, 0.02, terms=1) - plain)
    two = np.abs(_c2c_tf32_emulated(x, wq, 0.02, terms=2) - plain)
    assert (one > bound).all()
    assert (two <= bound).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_packed_dequant_bit_trick_matches_plain(bits):
    """The packed kernel's dequantisation, emulated in numpy: every
    sign-magnitude word w of the width (the code "-0" included) becomes
    ``float(0x4B000000 | sign << 31 | mag) - float(0x4B000000 | sign << 31)``
    = +-mag (+0 for "-0"), then one float32 multiply by the scale; bit for
    bit what the plain version's ``q * scale`` gives, at scales of both
    signs."""
    words = np.arange(2 ** bits, dtype=np.uint32)
    mag = words & np.uint32(2 ** (bits - 1) - 1)
    sign = ((words >> np.uint32(bits - 1)) & np.uint32(1)) << np.uint32(31)
    two23 = np.uint32(0x4B000000)
    q = ((two23 | sign | mag).view(np.float32)
         - (two23 | sign).view(np.float32))
    packed = np.zeros((2 ** bits, 1), np.uint8)
    packed[:, 0] = words                # lane 0 of byte 0 of each row
    for scale in (0.013, -0.37, 3.0):
        got = q * np.float32(scale)
        want = es.dequantize_packed(_t(packed.view(np.int8)), scale,
                                    bits)[:, 0].numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
