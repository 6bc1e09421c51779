"""The port's SNN training engine (``repro_torch.engine.snn_train``):
twins of tests/test_snn_train.py, and the port's trajectory against the
reference's from the same start on the same batches.

Left out: the reference's mesh tests (``test_mesh_matches_pinned_shards_
inprocess``, ``test_sharded_1x8_bit_exact_8dev``,
``test_elastic_conv_8dev_to_4dev``) — the port trains on one device; its
data-parallel half is later work on ``torch.distributed``.  What those
tests pin, a ``grad_shards`` fold whose arithmetic does not depend on the
devices, is held here against a hand-written fold.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.events import EventDatasetConfig as RefData
from repro.data.events import synthetic_event_dataset as ref_dataset
from repro.engine.snn_train import CONV_MODEL as REF_CONV
from repro.engine.snn_train import MLP_MODEL as REF_MLP
from repro.engine.snn_train import SNNTrainConfig as RefTrainConfig
from repro.engine.snn_train import train_snn_model as ref_train
from repro.snn.conv import ConvSNNConfig as RefConvCfg
from repro.snn.mlp import SNNConfig as RefSNNCfg

from repro_torch.convert import params_from_reference
from repro_torch.data.events import event_batch_at
from repro_torch.engine.snn_train import (CONV_MODEL, MLP_MODEL, SNNModel,
                                          SNNTrainConfig, make_snn_train_step,
                                          model_for, train_snn_model)
from repro_torch.engine.train_loop import init_train_state
from repro_torch.optim.adamw import adamw_update
from repro_torch.snn.conv import ConvSNNConfig
from repro_torch.snn.mlp import SNNConfig

DATA = RefData("train-test", 8, 8, num_steps=8, base_rate=0.02,
               signal_rate=0.5)
MLP_CFG = SNNConfig(layer_sizes=(DATA.n_in, 24, 10), num_steps=8)
CONV_CFG = ConvSNNConfig(in_shape=(2, 8, 8), conv_channels=(4,),
                         num_steps=8)
REF_CFGS = {"mlp": RefSNNCfg(layer_sizes=(DATA.n_in, 24, 10), num_steps=8),
            "conv": RefConvCfg(in_shape=(2, 8, 8), conv_channels=(4,),
                               num_steps=8)}


@pytest.fixture(scope="module")
def dataset():
    return ref_dataset(DATA, n_per_class=8, key=jax.random.key(0))


def _batch_of(spikes, labels, batch=16):
    def fn(step):
        return event_batch_at(spikes, labels, batch, step)
    return fn


def _quiet(s):
    pass


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


def _batch(spikes, labels, step, lr=None):
    sp, lb = event_batch_at(spikes, labels, 16, step)
    out = {"spikes": torch.from_numpy(np.ascontiguousarray(sp)),
           "labels": torch.from_numpy(lb)}
    if lr is not None:
        out["lr"] = torch.tensor(lr, dtype=torch.float32)
    return out


def test_unified_training_converges(dataset):
    spikes, labels = dataset
    cfg = SNNTrainConfig(steps=40, lr=2e-3, log_every=1000)
    params, hist = train_snn_model(MLP_MODEL, MLP_CFG,
                                   _batch_of(spikes, labels), cfg,
                                   key=_gen(), device="cpu", log_fn=_quiet)
    assert hist["loss"][-1] < hist["loss"][0]
    assert len(hist["acc"]) == 40 and len(hist["grad_norm"]) == 40
    assert hist["lr"][-1] == np.float32(2e-3)
    assert len(params) == len(MLP_CFG.layer_sizes) - 1
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in params)


def test_model_protocol_dispatch():
    assert model_for(MLP_CFG) is MLP_MODEL
    assert model_for(CONV_CFG) is CONV_MODEL
    assert isinstance(MLP_MODEL, SNNModel)
    assert isinstance(CONV_MODEL, SNNModel)
    with pytest.raises(TypeError):
        model_for(object())
    params = CONV_MODEL.init(_gen(0), CONV_CFG, device="cpu")
    specs = CONV_MODEL.layer_specs(params, CONV_CFG)
    assert len(specs) == 3          # Conv2d, SumPool2d, Dense head
    mats = MLP_MODEL.layer_specs(MLP_MODEL.init(_gen(0), MLP_CFG, "cpu"),
                                 MLP_CFG)
    assert [m.shape for m in mats] == [(DATA.n_in, 24), (24, 10)]
    assert all(isinstance(m, np.ndarray) for m in mats)


def test_lr_is_dynamic_through_one_step_object(dataset):
    """Two learning rates through one step object: each reaches the update
    (``metrics["lr"]``), and they give different parameters.  The step
    writes nothing into the state it was given."""
    spikes, labels = dataset
    opt_cfg = SNNTrainConfig(lr=1e-3).adamw()
    step = make_snn_train_step(MLP_MODEL, MLP_CFG, opt_cfg)
    params = MLP_MODEL.init(_gen(), MLP_CFG, device="cpu")
    state0 = init_train_state(None, params, opt_cfg).as_tree()
    kept = [p.clone() for p in params]
    outs = {}
    for lr in (1e-3, 1e-2):
        s, metrics = step(state0, _batch(spikes, labels, 0, lr))
        assert float(metrics["lr"]) == np.float32(lr)
        outs[lr] = s["params"][0]
    assert not torch.equal(outs[1e-3], outs[1e-2]), \
        "the dynamic lr was ignored by the update"
    assert all(torch.equal(a, b) for a, b in zip(kept, params))
    assert int(state0["opt"]["step"]) == 0


@pytest.mark.parametrize("family", ["mlp", "conv"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_grad_shards_fold_is_a_left_fold(dataset, family, k):
    """The step's gradient, loss and accuracy equal a hand-written fold —
    per-chunk ``torch.autograd.grad`` of the model's loss on contiguous
    chunks, summed left to right, times ``1/k`` — bit for bit, and so do
    the parameters after the update."""
    spikes, labels = dataset
    model, cfg = (MLP_MODEL, MLP_CFG) if family == "mlp" else \
        (CONV_MODEL, CONV_CFG)
    opt_cfg = SNNTrainConfig(lr=2e-3).adamw()
    params = model.init(_gen(), cfg, device="cpu")
    state = init_train_state(None, params, opt_cfg).as_tree()
    batch = _batch(spikes, labels, 3, 2e-3)
    new, metrics = make_snn_train_step(model, cfg, opt_cfg,
                                       grad_shards=k)(state, batch)
    size = 16 // k
    acc_l = acc_a = acc_g = None
    for i in range(k):
        leaves = [p.detach().requires_grad_(True) for p in params]
        sl = slice(i * size, (i + 1) * size)
        loss, acc = model.loss(leaves, batch["spikes"][:, sl],
                               batch["labels"][sl], cfg)
        grads = torch.autograd.grad(loss, leaves)
        if acc_l is None:
            acc_l, acc_a, acc_g = loss.detach(), acc, list(grads)
        else:
            acc_l, acc_a = acc_l + loss.detach(), acc_a + acc
            acc_g = [u + v for u, v in zip(acc_g, grads)]
    inv = 1.0 / k
    assert torch.equal(metrics["loss"], acc_l * inv)
    assert torch.equal(metrics["acc"], acc_a * inv)
    want, _, _ = adamw_update(opt_cfg, params, state["opt"],
                              [g * inv for g in acc_g], lr=batch["lr"])
    for a, b in zip(new["params"], want):
        assert torch.equal(a, b)


def test_grad_shards_must_divide_the_batch(dataset):
    spikes, labels = dataset
    opt_cfg = SNNTrainConfig().adamw()
    params = MLP_MODEL.init(_gen(), MLP_CFG, device="cpu")
    step = make_snn_train_step(MLP_MODEL, MLP_CFG, opt_cfg, grad_shards=3)
    with pytest.raises(ValueError, match="grad_shards=3"):
        step(init_train_state(None, params, opt_cfg).as_tree(),
             _batch(spikes, labels, 0))


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_resume_matches_uninterrupted(dataset, tmp_path, family):
    """Stop at step 10, re-launch with the same checkpoint dir: the final
    params are bit-identical to an uninterrupted 20-step run (step-keyed
    data, exactly-once restart)."""
    spikes, labels = dataset
    model, cfg = (MLP_MODEL, MLP_CFG) if family == "mlp" else \
        (CONV_MODEL, CONV_CFG)
    data = _batch_of(spikes, labels)
    logs = []

    def run(steps, ckpt):
        tc = SNNTrainConfig(steps=steps, lr=2e-3, checkpoint_dir=ckpt,
                            checkpoint_every=10, grad_shards=2,
                            log_every=1000)
        return train_snn_model(model, cfg, data, tc, key=_gen(),
                               device="cpu", log_fn=logs.append)

    ref, ref_hist = run(20, str(tmp_path / "ref"))
    run(10, str(tmp_path / "ab"))                   # "preempted" at step 10
    resumed, hist = run(20, str(tmp_path / "ab"))   # picks up at step 10
    assert len(hist["loss"]) == 10                  # only the remaining steps
    assert any("resumed" in s and "step 10" in s for s in logs)
    assert hist["loss"] == ref_hist["loss"][10:]
    for a, b in zip(resumed, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_trajectory_matches_reference(dataset, family):
    """From the reference's initial weights on the same step-keyed batches,
    5 steps with ``grad_shards=2``: the losses stay within rtol 1e-4 and
    the parameters within 5 lr.  Adam turns any near-zero gradient of
    either sign into a step of about lr, so float32 summation differences
    between the packages can move a weight by up to lr a step; the losses,
    summed over the batch, stay close."""
    spikes, labels = dataset
    steps, lr = 5, 2e-3
    rmodel, pmodel = (REF_MLP, MLP_MODEL) if family == "mlp" else \
        (REF_CONV, CONV_MODEL)
    rcfg, pcfg = REF_CFGS[family], (MLP_CFG if family == "mlp" else CONV_CFG)
    rinit = [np.asarray(w) for w in rmodel.init(jax.random.key(1), rcfg)]

    def data(step):
        return event_batch_at(spikes, labels, 16, step)

    rparams, rhist = ref_train(
        rmodel, rcfg, data, RefTrainConfig(steps=steps, lr=lr, grad_shards=2,
                                           log_every=1000),
        params=[jax.numpy.asarray(w) for w in rinit], log_fn=_quiet)
    pparams, phist = train_snn_model(
        pmodel, pcfg, data, SNNTrainConfig(steps=steps, lr=lr, grad_shards=2,
                                           log_every=1000),
        params=params_from_reference(rinit, "cpu"), device="cpu",
        log_fn=_quiet)
    np.testing.assert_allclose(phist["loss"], rhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(phist["acc"], rhist["acc"], atol=1e-7)
    for a, b in zip(rparams, pparams):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=lr * steps)
