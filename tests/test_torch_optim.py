"""The port's optimizer (``repro_torch.optim``) against the reference's:
AdamW with warmup, weight decay and clipping over three updates, the global
norm, and int8 block compression with error feedback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.optim.adamw import adamw_init as ref_init
from repro.optim.adamw import adamw_update as ref_update
from repro.optim.adamw import global_norm as ref_global_norm
from repro.optim.compress import CompressionConfig as RefComp
from repro.optim.compress import compress_gradients as ref_compress
from repro.optim.compress import decompress_gradients as ref_decompress
from repro.optim.compress import init_residual as ref_residual

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, \
    global_norm
from repro_torch.optim.compress import CompressionConfig, \
    compress_gradients, decompress_gradients, init_residual

# Elementwise float32 ops in the same order; XLA's pow and sqrt may differ
# from PyTorch's by an ulp, which an update carries at most relatively.
RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "layers": [(rng.normal(size=(3, 4)) * scale).astype(np.float32),
                       (rng.normal(size=(9,)) * scale).astype(np.float32)]}


def _jnp(tree):
    return {"w": jnp.asarray(tree["w"]),
            "layers": [jnp.asarray(x) for x in tree["layers"]]}


def _torch(tree):
    return {"w": torch.from_numpy(tree["w"].copy()),
            "layers": [torch.from_numpy(x.copy()) for x in tree["layers"]]}


def _leaves_np(tree):
    return [np.asarray(tree["w"])] + [np.asarray(x) for x in tree["layers"]]


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5, warmup_steps=2),
    dict(lr=3e-3, b2=0.999, weight_decay=0.0, grad_clip=float("inf"),
         warmup_steps=1),
    dict(lr=1e-3, weight_decay=0.05, grad_clip=100.0, warmup_steps=100),
])
def test_adamw_three_updates_match_reference(kw):
    """Three updates from the same parameters and gradients: clipping
    (active in the first case), the warmup ramp, weight decay and the bias
    corrections give the reference's parameters and moments at rtol 1e-6,
    the step count exactly, and the same metrics."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]
    rcfg, pcfg = RefAdamW(**kw), AdamWConfig(**kw)
    rp, rs = _jnp(params), ref_init(_jnp(params))
    pp, ps = _torch(params), adamw_init(_torch(params))
    for g in grads:
        rp, rs, rm = ref_update(rcfg, rp, rs, _jnp(g))
        pp, ps, pm = adamw_update(pcfg, pp, ps, _torch(g))
        for a, b in zip(_leaves_np(rp), _leaves_np(pp)):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-9)
        for k in ("m", "v"):
            for a, b in zip(_leaves_np(rs[k]), _leaves_np(ps[k])):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-12)
        assert int(ps["step"]) == int(rs["step"])
        assert ps["step"].dtype == torch.int32
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=RTOL)
        assert float(pm["lr"]) == float(rm["lr"])


def test_adamw_dynamic_lr_and_inputs_untouched():
    """A 0-d tensor ``lr`` overrides ``cfg.lr`` under the warmup ramp, as
    the reference's traced ``lr`` does; the caller's tensors are not
    written."""
    rng = np.random.default_rng(1)
    params, g = _tree(rng), _tree(rng)
    cfg = AdamWConfig(lr=1.0, warmup_steps=4)
    pp = _torch(params)
    before = [x.copy() for x in _leaves_np(pp)]
    new, _, m = adamw_update(cfg, pp, adamw_init(pp), _torch(g),
                             lr=torch.tensor(0.02, dtype=torch.float32))
    _, _, rm = ref_update(RefAdamW(lr=1.0, warmup_steps=4), _jnp(params),
                          ref_init(_jnp(params)), _jnp(g),
                          lr=jnp.float32(0.02))
    assert float(m["lr"]) == float(rm["lr"]) == np.float32(0.02) * \
        np.float32(0.25)
    for a, b in zip(before, _leaves_np(pp)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(_leaves_np(new)[0], before[0])


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    t = _tree(rng, scale=10.0)
    np.testing.assert_allclose(float(global_norm(_torch(t))),
                               float(ref_global_norm(_jnp(t))), rtol=RTOL)


@pytest.mark.parametrize("block", [16, 32, 256])
def test_compression_bit_exact_with_reference(block):
    """int8 codes and float32 block scales equal the reference's eager
    ones bit for bit (half-to-even rounding, true division by 127), and so
    does the error-feedback residual, over two rounds."""
    rng = np.random.default_rng(block)
    shapes = [(37, 13), (5,), (2, 3, 17)]
    rcfg, pcfg = RefComp(enabled=True, block=block), \
        CompressionConfig(enabled=True, block=block)
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads[0][0, :4] = [0.5, -0.5, 1.5, 127.0]       # ties and the block max
    rres = ref_residual([jnp.asarray(g) for g in grads])
    pres = init_residual([torch.from_numpy(g) for g in grads])
    for _ in range(2):
        rc, rres = ref_compress([jnp.asarray(g) for g in grads], rres, rcfg)
        pc, pres = compress_gradients([torch.from_numpy(g) for g in grads],
                                      pres, pcfg)
        for (rq, rsc), (pq, psc) in zip(rc, pc):
            assert pq.dtype == torch.int8 and psc.dtype == torch.float32
            np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
            np.testing.assert_array_equal(psc.numpy(), np.asarray(rsc))
        for a, b in zip(rres, pres):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        rd = ref_decompress(rc, [jnp.asarray(g) for g in grads])
        pd = decompress_gradients(pc, [torch.from_numpy(g) for g in grads])
        for a, b in zip(rd, pd):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_compression_roundtrip_unbiased():
    """Twin of tests/test_train_loop.py::test_compression_roundtrip_unbiased:
    the residual exactly accounts for the quantization error."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(37, 13))
                                   .astype(np.float32))}
    cfg = CompressionConfig(enabled=True, block=32)
    comp, res = compress_gradients(grads, init_residual(grads), cfg)
    approx = decompress_gradients(comp, grads)
    np.testing.assert_allclose((approx["w"] + res["w"]).numpy(),
                               grads["w"].numpy(), atol=1e-6)


def test_decompress_preserves_leaf_dtype():
    """Twin of tests/test_train_loop.py::test_decompress_preserves_leaf_dtype."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(17, 5))
                                   .astype(np.float32)).to(torch.bfloat16),
             "b": torch.from_numpy(rng.normal(size=(33,)).astype(np.float32))}
    cfg = CompressionConfig(enabled=True, block=16)
    comp, _ = compress_gradients(grads, init_residual(grads), cfg)
    approx = decompress_gradients(comp, grads)
    assert approx["w"].dtype == torch.bfloat16
    assert approx["b"].dtype == torch.float32
    np.testing.assert_allclose(approx["w"].float().numpy(),
                               grads["w"].float().numpy(), atol=0.1)
