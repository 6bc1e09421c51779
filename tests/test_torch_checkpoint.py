"""The port's checkpoints (``repro_torch.checkpoint``): atomic commit, the
async writer and its retention, and the reference's on-disk format — a
checkpoint written by either package restores in the other bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.engine.train_loop import init_train_state as ref_state
from repro.optim.adamw import AdamWConfig as RefAdamW

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core.pytree import tree_leaves
from repro_torch.engine.train_loop import init_train_state
from repro_torch.optim.adamw import AdamWConfig


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "m": rng.normal(size=(8, 16)).astype(np.float32)}


def _tree(seed=0):
    a = _arrays(seed)
    return {"w": torch.from_numpy(a["w"]),
            "opt": {"m": torch.from_numpy(a["m"]),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _ref_tree(seed=0):
    a = _arrays(seed)
    return {"w": jnp.asarray(a["w"]),
            "opt": {"m": jnp.asarray(a["m"]), "step": jnp.asarray(3)}}


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t)
    assert latest_step(str(tmp_path)) == 10
    r = restore_checkpoint(str(tmp_path), 10, t, device="cpu")
    assert isinstance(r["opt"], dict) and set(r) == {"w", "opt"}
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        _same(a, b)


def test_atomic_commit_ignores_tmp(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_00000007.tmp")    # a crashed writer
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "missing")) is None


def test_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]
    assert mgr.latest() == 4


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The async writer writes the values at ``save_async``, whatever the
    caller does to its tensors afterwards."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    want = t["w"].clone()
    mgr.save_async(1, t)
    t["w"].add_(1.0)
    mgr.wait()
    _same(restore_checkpoint(str(tmp_path), 1, t, device="cpu")["w"], want)


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref_save(str(tmp_path), 3, _ref_tree())
    assert latest_step(str(tmp_path)) == 3
    r = restore_checkpoint(str(tmp_path), 3, _tree(1), device="cpu")
    for a, b in zip(tree_leaves(_tree()), tree_leaves(r)):
        _same(a, b)


def test_port_checkpoint_restores_in_reference(tmp_path):
    save_checkpoint(str(tmp_path), 4, _tree())
    r = ref_restore(str(tmp_path), 4, _ref_tree(1))
    for a, b in zip(jax.tree.leaves(_ref_tree()), jax.tree.leaves(r)):
        _same(a, b)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_train_state_crosses_packages(tmp_path, direction):
    """A whole SNN train state — parameter list, Adam moments, int32 step —
    keeps its leaf order across packages (dict keys sorted as JAX sorts
    them)."""
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=(6, 4)).astype(np.float32),
          rng.normal(size=(4, 3)).astype(np.float32)]
    rstate = ref_state(None, [jnp.asarray(w) for w in ws],
                       RefAdamW()).as_tree()
    rstate["opt"]["m"] = [m + 1.5 for m in rstate["opt"]["m"]]
    rstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    pstate = init_train_state(None, [torch.from_numpy(w) for w in ws],
                              AdamWConfig()).as_tree()
    pstate["opt"]["m"] = [m + 1.5 for m in pstate["opt"]["m"]]
    pstate["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    if direction == "ref_to_port":
        ref_save(str(tmp_path), 7, rstate)
        got = restore_checkpoint(str(tmp_path), 7, pstate, device="cpu")
        want = tree_leaves(pstate)
        leaves = tree_leaves(got)
    else:
        save_checkpoint(str(tmp_path), 7, pstate)
        got = ref_restore(str(tmp_path), 7, rstate)
        want = jax.tree.leaves(rstate)
        leaves = jax.tree.leaves(got)
    assert len(leaves) == len(want) == 7
    for a, b in zip(want, leaves):
        _same(a, b)
