"""Conv layer specs and the shared-weight lowering in the port: twin of
``tests/test_conv.py``.

Each test draws the same seeded kernels for both packages, asserts the
reference test's own assertions on the port, and holds the port's result
to the reference's.  Unrolled matrices, share ids, tables, accounting and
replays are exact (equal arrays); the unroll against
``torch.nn.functional.conv2d`` and the sum pool against a numpy sum keep
the reference test's ``atol=1e-5`` and ``rtol=1e-6`` (float32 sums in
another order).  ``test_layer_specs_match_training_forward`` and
``test_trained_conv_model_bit_exact_batch`` are twinned in
``tests/test_torch_snn.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.accelerator import map_model as ref_map_model
from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.layers import Conv2d as RefConv2d
from repro.core.layers import Dense as RefDense
from repro.core.layers import SumPool2d as RefSumPool2d
from repro.core.mapping import MappingError as RefMappingError

from repro_torch.core.accelerator import map_model
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.layers import Conv2d, Dense, SumPool2d, as_layer_spec
from repro_torch.core.mapping import MappingError

torch.set_num_threads(1)

SPEC_ARGS = dict(n_cores=8, n_engines=4, n_caps=8, weight_mem_bytes=1 << 16)
SPEC = AcceleratorSpec("test", **SPEC_ARGS)
REF_SPEC = RefSpec("test", **SPEC_ARGS)


def _rand_kernel(rng, c_out, c_in, k, density=0.7):
    kern = rng.normal(0, 0.8, (c_out, c_in, k, k)).astype(np.float32)
    kern[rng.random(kern.shape) > density] = 0
    return kern


def test_conv2d_unroll_matches_conv2d(rng):
    """``x @ unroll(conv)`` equals ``F.conv2d`` for stride/pad combinations
    (atol 1e-5), and the unrolled matrix equals the reference's."""
    for stride, pad in [(1, 0), (1, 1), (2, 1), (3, 0)]:
        kern = _rand_kernel(rng, 3, 2, 3)
        kw = dict(kernel=kern, in_shape=(2, 7, 7), stride=stride,
                  padding=pad)
        conv = Conv2d(**kw)
        x = rng.random((4, 2, 7, 7)).astype(np.float32)
        want = F.conv2d(torch.from_numpy(x), torch.from_numpy(kern),
                        stride=stride, padding=pad).numpy()
        got = x.reshape(4, -1) @ conv.unroll()
        np.testing.assert_allclose(got, want.reshape(4, -1), atol=1e-5,
                                   err_msg=f"stride={stride} pad={pad}")
        assert conv.n_dest == int(np.prod(conv.out_shape))
        np.testing.assert_array_equal(conv.unroll(), RefConv2d(**kw).unroll())
        assert conv.out_shape == RefConv2d(**kw).out_shape


def test_share_ids_name_kernel_taps(rng):
    """Every unrolled synapse's share id is its kernel tap; equal ids carry
    equal weights; id count == stored-tap count == unique_weight_bytes; the
    ids equal the reference's."""
    kern = _rand_kernel(rng, 2, 2, 3, density=0.6)
    kw = dict(kernel=kern, in_shape=(2, 6, 6), stride=1, padding=1)
    conv = Conv2d(**kw)
    w, ids = conv.unroll(), conv.share_ids()
    assert ids.shape == w.shape
    np.testing.assert_array_equal(ids >= 0, w != 0)
    flat_k = kern.reshape(-1)
    nz = ids >= 0
    np.testing.assert_array_equal(w[nz], flat_k[ids[nz]])
    assert len(np.unique(ids[nz])) == conv.unique_weight_bytes \
        == int((kern != 0).sum())
    assert int(nz.sum()) > conv.unique_weight_bytes
    np.testing.assert_array_equal(ids, RefConv2d(**kw).share_ids())


def test_shared_sram_allocation(rng):
    """After mapping, each engine's A-SYN SRAM holds at most one word per
    kernel tap while dense layers store one word per synapse; the byte
    accounting and every round's words equal the reference's."""
    kern = _rand_kernel(rng, 3, 2, 3)
    ckw = dict(kernel=kern, in_shape=(2, 6, 6), stride=1, padding=1)
    w = rng.normal(0, 0.7, (Conv2d(**ckw).n_dest, 6)).astype(np.float32)
    model = map_model([Conv2d(**ckw), Dense(w=w)], SPEC)
    ref = ref_map_model([RefConv2d(**ckw), RefDense(w=w)], REF_SPEC)
    cl, dl = model.layers
    assert cl.shared_weights and not dl.shared_weights
    assert cl.weight_bytes == int((np.asarray(cl.layer_spec.kernel) != 0).sum())
    assert cl.weight_bytes <= int((kern != 0).sum())
    assert dl.weight_bytes == int((np.asarray(dl.layer_spec.w) != 0).sum())
    assert dl.weight_bytes <= int((w != 0).sum())
    for rnd in cl.rounds:
        t = rnd.tables
        used = int(t.sn_valid.sum())
        words = t.weight_mem.shape[1]
        assert words <= cl.weight_bytes
        assert used > words, "conv round shows no weight sharing"
    assert cl.sram_bytes == sum(r.tables.n_weight_words for r in cl.rounds)
    assert cl.weight_bytes <= cl.sram_bytes \
        <= cl.weight_bytes * SPEC.n_engines * len(cl.rounds)
    assert dl.sram_bytes <= dl.weight_bytes
    for pl, rl in zip(model.layers, ref.layers):
        assert (pl.weight_bytes, pl.sram_bytes, pl.shared_weights) == \
            (rl.weight_bytes, rl.sram_bytes, rl.shared_weights)
        assert [r.tables.n_weight_words for r in pl.rounds] == \
            [r.tables.n_weight_words for r in rl.rounds]
        for pr, rr in zip(pl.rounds, rl.rounds):
            np.testing.assert_array_equal(pr.tables.weight_mem,
                                          rr.tables.weight_mem)


def test_map_model_rejects_physical_sram_overflow(rng):
    """A conv layer that passes the unique-kernel-byte precheck but not the
    physical allocation (taps replicated per engine and round) is
    refused, as the reference refuses it."""
    kern = _rand_kernel(rng, 2, 1, 3, density=1.0)   # 18 unique taps
    args = dict(n_cores=1, n_engines=4, n_caps=8, weight_mem_bytes=20)
    with pytest.raises(MappingError, match="round"):
        map_model([Conv2d(kernel=kern, in_shape=(1, 6, 6))],
                  AcceleratorSpec("tight", **args))
    with pytest.raises(RefMappingError, match="round"):
        ref_map_model([RefConv2d(kernel=kern, in_shape=(1, 6, 6))],
                      RefSpec("tight", **args))


def test_replay_coo_matches_dense_weights(rng):
    """The COO replay and the dense replay describe the same synapses, bit
    for bit, each pair once; both equal the reference's."""
    kern = _rand_kernel(rng, 2, 1, 3)
    model = map_model([Conv2d(kernel=kern, in_shape=(1, 6, 6), stride=2,
                              padding=1)], SPEC)
    ref = ref_map_model([RefConv2d(kernel=kern, in_shape=(1, 6, 6),
                                   stride=2, padding=1)], REF_SPEC)
    for rnd, rrnd in zip(model.layers[0].rounds, ref.layers[0].rounds):
        n_local = len(rnd.neuron_ids)
        w_dense = rnd.tables.dense_weights(n_local)
        src, dest, vals = rnd.tables.replay_coo()
        w_coo = np.zeros_like(w_dense)
        np.add.at(w_coo, (src, dest), vals)
        np.testing.assert_array_equal(w_coo, w_dense)
        assert len(set(zip(src.tolist(), dest.tolist()))) == len(src)
        for got, want in zip((src, dest, vals), rrnd.tables.replay_coo()):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(w_dense,
                                      rrnd.tables.dense_weights(n_local))


def test_sum_pool_is_depthwise_sum(rng):
    """The sum pool is a depthwise 2x2 sum (rtol 1e-6), its matrix the
    reference's."""
    pool = SumPool2d((3, 4, 4), pool=2)
    assert pool.out_shape == (3, 2, 2)
    x = rng.random((2, 3, 4, 4)).astype(np.float32)
    got = (x.reshape(2, -1) @ pool.unroll()).reshape(2, 3, 2, 2)
    want = x.reshape(2, 3, 2, 2, 2, 2).sum(axis=(3, 5))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert pool.unique_weight_bytes == 3 * 4
    ref = RefSumPool2d((3, 4, 4), pool=2)
    np.testing.assert_array_equal(pool.unroll(), ref.unroll())
    np.testing.assert_array_equal(pool.share_ids(), ref.share_ids())


def test_map_model_rejects_shape_mismatch(rng):
    """A dense layer whose input is not the conv's output, and a 4-D bare
    array, are refused with the reference's messages."""
    kern = _rand_kernel(rng, 2, 1, 3)
    w = rng.normal(0, 1, (7, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="expects"):
        map_model([Conv2d(kernel=kern, in_shape=(1, 5, 5)), Dense(w=w)],
                  SPEC)
    with pytest.raises(ValueError, match="expects"):
        ref_map_model([RefConv2d(kernel=kern, in_shape=(1, 5, 5)),
                       RefDense(w=w)], REF_SPEC)
    with pytest.raises(ValueError, match="2-D"):
        as_layer_spec(rng.normal(0, 1, (2, 2, 3, 3)))
