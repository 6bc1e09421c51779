"""The port's SNN training engine (``repro_torch.engine.snn_train``):
twins of tests/test_snn_train.py, and the port's trajectory against the
reference's from the same start on the same batches.

The mesh twins (``test_mesh_matches_pinned_shards_inprocess``,
``test_sharded_1x8_bit_exact_8dev``, ``test_elastic_conv_8dev_to_4dev``)
train on meshes spoofed in this process (``snn_train_mesh(spoof=N)``: N
shards of the CPU) and hold them bit for bit to single-device training at
the same ``grad_shards``; the reference's own mesh training does not run
on the installed JAX (its ``shard_map`` call passes ``check_rep``), so the
8-way run is also held to the reference's single-device ``grad_shards=8``
training at the trajectory twin's tolerances.
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
                                          SNNTrainConfig, _batch_split,
                                          make_snn_train_step, model_for,
                                          snn_train_mesh, train_snn_model)
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


# --------------------------------------------------------- sharded bit-exact

def _models(family):
    return (MLP_MODEL, MLP_CFG) if family == "mlp" else (CONV_MODEL, CONV_CFG)


def _train(model, cfg, data, steps, **kw):
    tc = SNNTrainConfig(steps=steps, lr=2e-3, log_every=1000, **kw)
    return train_snn_model(model, cfg, data, tc, key=_gen(),
                           device=None if "mesh" in kw else "cpu",
                           log_fn=_quiet)


def test_mesh_matches_pinned_shards_inprocess(dataset):
    """Training over the default mesh (every device: the one CPU) and over
    a spoofed 2-way mesh == single-device training with ``grad_shards``
    pinned to the mesh's split — same losses, same params, bit for bit."""
    spikes, labels = dataset
    data = _batch_of(spikes, labels)
    for mesh in (snn_train_mesh(device="cpu"),
                 snn_train_mesh(device="cpu", spoof=2)):
        k = _batch_split(mesh, (DATA.num_steps, 16, DATA.n_in))
        assert k == mesh.size
        p_mesh, h_mesh = _train(MLP_MODEL, MLP_CFG, data, 10, mesh=mesh)
        p_single, h_single = _train(MLP_MODEL, MLP_CFG, data, 10,
                                    grad_shards=k)
        assert h_mesh["loss"] == h_single["loss"]
        for a, b in zip(p_mesh, p_single):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_sharded_1x8_bit_exact_8dev(dataset, family):
    """On a spoofed 8-way mesh, data-parallel training is bit-exact with
    single-device ``grad_shards=8`` training for the same data order; and
    it stays within the trajectory twin's tolerances of the reference's
    single-device ``grad_shards=8`` training from the same start."""
    spikes, labels = dataset
    data = _batch_of(spikes, labels)
    model, cfg = _models(family)
    mesh = snn_train_mesh(device="cpu", spoof=8)
    ps, hs = _train(model, cfg, data, 8, mesh=mesh)
    p1, h1 = _train(model, cfg, data, 8, grad_shards=8)
    assert hs["loss"] == h1["loss"], f"{family} loss trajectory"
    for li, (a, b) in enumerate(zip(ps, p1)):
        assert torch.equal(a, b), f"{family} params[{li}] diverged"

    steps, lr = 5, 2e-3
    rmodel = REF_MLP if family == "mlp" else REF_CONV
    rinit = [np.asarray(w) for w in rmodel.init(jax.random.key(1),
                                                REF_CFGS[family])]
    rparams, rhist = ref_train(
        rmodel, REF_CFGS[family], data,
        RefTrainConfig(steps=steps, lr=lr, grad_shards=8, log_every=1000),
        params=[jax.numpy.asarray(w) for w in rinit], log_fn=_quiet)
    pparams, phist = train_snn_model(
        model, cfg, data, SNNTrainConfig(steps=steps, lr=lr, mesh=mesh,
                                         log_every=1000),
        params=params_from_reference(rinit, "cpu"), log_fn=_quiet)
    np.testing.assert_allclose(phist["loss"], rhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(phist["acc"], rhist["acc"], atol=1e-7)
    for a, b in zip(rparams, pparams):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=lr * steps)


def test_elastic_conv_8dev_to_4dev(dataset, tmp_path):
    """Checkpoint conv-SNN training on a spoofed 8-way mesh at step 4,
    resume on a 4-way mesh to step 8 (``grad_shards`` pinned to 8): the
    loss trajectory and final params match the uninterrupted 8-way run
    exactly."""
    spikes, labels = dataset
    data = _batch_of(spikes, labels)

    def phase(n, ckpt, steps):
        return _train(CONV_MODEL, CONV_CFG, data, steps,
                      mesh=snn_train_mesh(device="cpu", spoof=n),
                      grad_shards=8, checkpoint_dir=str(ckpt),
                      checkpoint_every=4)

    ref, ref_hist = phase(8, tmp_path / "ref", 8)     # uninterrupted
    _, a_hist = phase(8, tmp_path / "ab", 4)          # checkpoint at 4
    b, b_hist = phase(4, tmp_path / "ab", 8)          # resume on 4
    assert a_hist["loss"] == ref_hist["loss"][:4]
    assert b_hist["loss"] == ref_hist["loss"][4:]
    for x, y in zip(b, ref):
        assert torch.equal(x, y), "elastic params diverged"


def test_mesh_fallbacks_train_replicated_and_warn(dataset, caplog):
    """A ``grad_shards`` that is not a multiple of the mesh's split, or a
    batch the mesh cannot split, trains on the first device alone, says
    so once, and still equals single-device training."""
    spikes, labels = dataset
    data = _batch_of(spikes, labels)
    cases = ((snn_train_mesh(device="cpu", spoof=4), 2, "not a multiple"),
             (snn_train_mesh(device="cpu", spoof=3), 4, "does not split"))
    for mesh, k, words in cases:
        caplog.clear()
        with caplog.at_level("WARNING"):
            p_mesh, h_mesh = _train(MLP_MODEL, MLP_CFG, data, 3, mesh=mesh,
                                    grad_shards=k)
        hits = [r for r in caplog.records if words in r.getMessage()]
        assert len(hits) == 1, [r.getMessage() for r in caplog.records]
        p1, h1 = _train(MLP_MODEL, MLP_CFG, data, 3, grad_shards=k)
        assert h_mesh["loss"] == h1["loss"]
        assert all(torch.equal(a, b) for a, b in zip(p_mesh, p1))
    with pytest.raises(ValueError, match="mesh's first device"):
        train_snn_model(MLP_MODEL, MLP_CFG, data,
                        SNNTrainConfig(steps=1, mesh=cases[0][0]),
                        device="cuda:0" if torch.cuda.is_available()
                        else "cpu:1", log_fn=_quiet)
