"""Elastic restart through the port's launcher (the twin of
``tests/test_elastic.py``, in process): train on a spoofed mesh,
checkpoint, resume on a mesh of another size, go on training.  Stronger
than the reference's test, which only checks that the resume happened:
the resumed run's every loss and its final state (parameters and AdamW
moments) equal an uninterrupted run's bit for bit.  The checkpoint is the
reference's on-disk format, so the reference restores it too."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import restore_checkpoint as ref_restore

from repro_torch.core.pytree import tree_leaves
from repro_torch.launch.train import train

# the reference test's run: the smoke InternLM2, seq 32, batch 8, AdamW
# lr 1e-3 with one warm-up step, 10 steps then 10 more after the restart
KW = dict(smoke=True, seq=32, batch=8, lr=1e-3, warmup_steps=1,
          device="cpu", log_fn=lambda s: None)


def _spoofed(shape):
    return dict(mesh=shape, spoof_devices=shape[0] * shape[1])


@pytest.mark.parametrize("arch,first,second", [
    ("internlm2_1_8b", (4, 2), (2, 2)),     # the reference's 8 -> 4 devices
    ("internlm2_1_8b", (2, 2), (4, 2)),     # and back up
    ("internlm2_1_8b", (4, 2), (1, 1)),     # down to one device
    ("mixtral_8x7b", (2, 2), (2, 2)),       # the meshed MoE, same layout
])
def test_elastic_restart_is_bit_exact(tmp_path, arch, first, second):
    whole, hist = train(arch, steps=20, **_spoofed(first), **KW)
    ckpt = str(tmp_path / "ckpt")
    _, a = train(arch, steps=10, ckpt=ckpt, checkpoint_every=10,
                 **_spoofed(first), **KW)
    assert a["checkpoints"] == [10] and os.listdir(ckpt) == ["step_00000010"]
    resumed, b = train(arch, steps=20, ckpt=ckpt, checkpoint_every=10,
                       **_spoofed(second), **KW)
    assert b["start"] == 10                     # resumed across mesh sizes
    assert b["checkpoints"] == [20]
    assert a["loss"] + b["loss"] == hist["loss"]
    assert np.isfinite(hist["loss"]).all()
    for x, y in zip(tree_leaves(whole), tree_leaves(resumed)):
        assert torch.equal(x, y)
    assert int(resumed["opt"]["step"]) == 20


def test_restart_restores_the_reference_format(tmp_path):
    """The checkpoint the port's launcher writes is the reference's: the
    reference's ``restore_checkpoint`` reads it back bit for bit."""
    state, _ = train("internlm2_1_8b", steps=2, ckpt=str(tmp_path),
                     checkpoint_every=2, **KW)
    like = jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32),
                        state)
    got = ref_restore(str(tmp_path), 2, like)
    for x, y in zip(jax.tree.leaves(got), tree_leaves(state)):
        assert np.array_equal(np.asarray(x), y.numpy())
