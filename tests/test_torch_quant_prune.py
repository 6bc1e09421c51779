"""The port's pytree quantization and L1 pruning against the reference
package: the same numpy-seeded weights give identical codes, scales,
dequantized values, masks and sparsities, for numpy and torch leaves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prune as ref_prune
from repro.core import quant as ref_quant

from repro_torch.core import prune, quant
from repro_torch.core.pytree import tree_leaves, tree_map


def _params(rng):
    return {"layers": [rng.normal(size=(12, 9)).astype(np.float32),
                       rng.normal(size=(9, 4)).astype(np.float32) * 3],
            "bias": rng.normal(size=(4,)).astype(np.float32),
            "conv": (rng.normal(size=(3, 2, 3, 3)).astype(np.float32),),
            "step": np.int32(7)}


def _as(kind, tree):
    if kind == "numpy":
        return tree
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_pytree_matches_reference(kind, bits):
    params = _params(np.random.default_rng(bits))
    ref_q, ref_dq = ref_quant.quantize_pytree(
        tree_map(jnp.asarray, params), bits=bits)
    q, dq = quant.quantize_pytree(_as(kind, params), bits=bits)
    for path in (("layers", 0), ("layers", 1), ("conv", 0)):
        got, want = q, ref_q
        got_dq, want_dq = dq, ref_dq
        for k in path:
            got, want = got[k], want[k]
            got_dq, want_dq = got_dq[k], want_dq[k]
        assert isinstance(got, quant.QuantizedTensor)
        np.testing.assert_array_equal(got.q, np.asarray(want.q))
        np.testing.assert_array_equal(got.scale, np.asarray(want.scale))
        assert got.q.dtype == np.int8
        assert isinstance(got_dq, torch.Tensor) == (kind == "torch")
        np.testing.assert_array_equal(_np(got_dq), np.asarray(want_dq))
    # biases and scalars pass through untouched, None stays None
    assert not isinstance(q["bias"], quant.QuantizedTensor)
    np.testing.assert_array_equal(_np(dq["bias"]), params["bias"])
    assert int(q["step"]) == 7 and int(dq["step"]) == 7
    assert quant.quantize_pytree({"a": None})[1] == {"a": None}


def test_quantize_pytree_skips_biases(rng):
    params = {"w": rng.normal(size=(8, 8)).astype(np.float32),
              "bias": np.zeros((8,), np.float32)}
    qtree, dq = quant.quantize_pytree(params)
    assert isinstance(qtree["w"], quant.QuantizedTensor)
    assert not isinstance(qtree["bias"], quant.QuantizedTensor)
    assert dq["w"].shape == (8, 8)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantization_error_matches_reference(kind, bits):
    w = np.random.default_rng(10 + bits).normal(size=(64, 64)) \
        .astype(np.float32)
    want = ref_quant.quantization_error(jnp.asarray(w), bits=bits)
    got = quant.quantization_error(torch.from_numpy(w) if kind == "torch"
                                   else w, bits=bits)
    assert _np(got) == np.asarray(want)
    assert float(got) <= float(np.abs(w).max()) / (2 ** (bits - 1) - 1)


def _tied(rng, shape):
    """Weights drawn from few values, so magnitudes tie at the threshold."""
    return rng.choice(np.float32([-0.5, -0.25, 0.0, 0.25, 0.5, 1.0]),
                      size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("amount", [-0.1, 0.0, 0.004, 0.3, 0.5, 0.7, 0.999,
                                    1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_l1_prune_mask_matches_reference(kind, amount, ties):
    rng = np.random.default_rng(3)
    w = _tied(rng, (50, 40)) if ties else \
        rng.normal(size=(50, 40)).astype(np.float32)
    want = np.asarray(ref_prune.l1_prune_mask(jnp.asarray(w), amount))
    got = prune.l1_prune_mask(torch.from_numpy(w) if kind == "torch" else w,
                              amount)
    assert isinstance(got, torch.Tensor) == (kind == "torch")
    got = _np(got)
    assert got.dtype == np.bool_ and got.shape == w.shape
    np.testing.assert_array_equal(got, want)


def test_prune_amount(rng):
    w = torch.from_numpy(rng.normal(size=(50, 40)).astype(np.float32))
    mask = prune.l1_prune_mask(w, 0.7)
    assert abs(float((~mask).float().mean()) - 0.7) < 0.02
    assert float(w[mask].abs().min()) >= float(w[~mask].abs().max()) - 1e-6


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("amount", [0.25, 0.5, 0.9])
def test_prune_pytree_and_sparsity_match_reference(kind, amount):
    params = _params(np.random.default_rng(int(amount * 100)))
    # the reference splits its (pruned, mask) pairs with an is_leaf=tuple
    # map, which also catches a tuple of the tree itself: lists only here
    params["conv"] = list(params["conv"])
    ref_pruned, ref_masks = ref_prune.prune_pytree(
        tree_map(jnp.asarray, params), amount)
    pruned, masks = prune.prune_pytree(_as(kind, params), amount)
    assert masks["bias"] is None and masks["step"] is None
    for got, want in zip(tree_leaves(masks), tree_leaves(ref_masks)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for got, want in zip(tree_leaves(pruned), tree_leaves(ref_pruned)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert prune.sparsity(pruned) == ref_prune.sparsity(ref_pruned)
    assert prune.sparsity(_as(kind, params)) == \
        ref_prune.sparsity(tree_map(jnp.asarray, params))


def test_prune_pytree_and_sparsity(rng):
    params = {"a": torch.from_numpy(rng.normal(size=(20, 20))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}
    pruned, masks = prune.prune_pytree(params, 0.5)
    assert masks["b"] is None                # 1-D left alone
    assert 0.4 < prune.sparsity(pruned) < 0.6


def test_pytree_helpers_keep_structure():
    from collections import namedtuple
    Pair = namedtuple("Pair", "a b")
    tree = {"z": [1, (2, None)], "a": Pair(3, {"k": 4})}
    doubled = tree_map(lambda x: 2 * x, tree)
    assert doubled == {"z": [2, (4, None)], "a": Pair(6, {"k": 8})}
    assert type(doubled["a"]) is Pair
    assert tree_leaves(tree) == [3, 4, 1, 2]     # sorted keys, None skipped
