"""The port's spiking models (``repro_torch.snn``) against the reference's,
and twins of tests/test_snn.py, tests/test_conv.py's training cases and
tests/test_noise.py::test_snn_accuracy_degrades_gracefully.

Weights cross with ``convert.params_from_reference``; inputs are numpy
draws from a seed.  Spike trains are compared for equality, a flip being
accepted only where the reference's membrane lies within 4 ulp of the
threshold (``_torch_helpers.assert_spikes_match``); gradients at rtol 1e-4
with a floor of 1e-6 max|g| (``assert_grads_close``; 1e-5 max|g| for conv
kernels, whose taps sum over every position).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lif import LIFParams as RefLIF
from repro.core.prune import prune_pytree as ref_prune
from repro.core.quant import quantize_pytree as ref_quantize
from repro.data.events import EventDatasetConfig as RefData
from repro.data.events import event_batches as ref_event_batches
from repro.data.events import synthetic_event_dataset as ref_dataset
from repro.engine import MLP_MODEL as REF_MLP
from repro.engine import SNNTrainConfig as RefTrainConfig
from repro.engine import train_snn_model as ref_train
from repro.snn.conv import ConvSNNConfig as RefConvCfg
from repro.snn.conv import conv_snn_forward as ref_conv_forward
from repro.snn.conv import conv_snn_loss as ref_conv_loss
from repro.snn.conv import init_conv_snn as ref_init_conv
from repro.snn.conv import layer_specs as ref_layer_specs
from repro.snn.mlp import SNNConfig as RefSNNCfg
from repro.snn.mlp import init_snn as ref_init_snn
from repro.snn.mlp import snn_forward as ref_forward
from repro.snn.mlp import snn_loss as ref_loss

from _torch_helpers import (assert_grads_close, assert_spikes_match,
                            oracle_membranes)
from repro_torch.convert import params_from_reference
from repro_torch.core.accelerator import map_model, reference_forward, \
    run_batch
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.layers import Conv2d
from repro_torch.core.lif import LIFParams
from repro_torch.core.noise import AnalogNoise, perturb_weights
from repro_torch.core.prune import prune_pytree, sparsity
from repro_torch.core.quant import quantize_pytree
from repro_torch.data.events import EventDatasetConfig, event_batches, \
    synthetic_event_dataset
from repro_torch.engine import CONV_MODEL, MLP_MODEL, SNNTrainConfig, \
    train_snn_model
from repro_torch.engine import batched_run as br
from repro_torch.snn.conv import ConvSNNConfig, conv_snn_forward, \
    conv_snn_loss, layer_specs
from repro_torch.snn.mlp import SNNConfig, snn_forward, \
    snn_forward_batch_major, snn_loss


def _quiet(s):
    pass


def _np(t):
    return t.detach().cpu().numpy()


def _raster(rng, t, b, n, p):
    return (rng.random((t, b, n)) < p).astype(np.float32)


# ------------------------------------------------------------- MLP twins

MLP_CASES = [((128, 48, 24, 10), 15, 32, 0.2, 2.0),
             ((64, 32, 10), 9, 7, 0.35, 1.5)]


@pytest.mark.parametrize("sizes,t,b,p,gain", MLP_CASES)
def test_mlp_forward_loss_grads_match_reference(sizes, t, b, p, gain):
    rng = np.random.default_rng(len(sizes))
    lif = dict(beta=0.9, threshold=1.0)
    rcfg = RefSNNCfg(sizes, RefLIF(**lif), num_steps=t)
    pcfg = SNNConfig(sizes, LIFParams(**lif), num_steps=t)
    ws = [np.asarray(w) * gain for w in ref_init_snn(jax.random.key(1),
                                                     rcfg)]
    spikes = _raster(rng, t, b, sizes[0], p)
    labels = rng.integers(0, 10, b)
    rc, ro = ref_forward([jnp.asarray(w) for w in ws], jnp.asarray(spikes),
                         rcfg)
    tp = params_from_reference(ws, "cpu")
    pc, po = snn_forward(tp, torch.from_numpy(spikes), pcfg)
    assert po.shape == (t, b, sizes[-1]) and pc.shape == (b, sizes[-1])
    assert float(po.sum()) > 0
    vm = oracle_membranes(ws, pcfg.lif, spikes)[-1]
    assert_spikes_match(np.asarray(ro), _np(po), vm, 1.0, ctx="mlp output")
    np.testing.assert_array_equal(_np(pc), _np(po).sum(axis=0))
    # batch-major view of the same forward
    bc, bo = snn_forward_batch_major(tp, torch.from_numpy(
        spikes.swapaxes(0, 1).copy()), pcfg)
    assert torch.equal(bc, pc) and torch.equal(bo, po.transpose(0, 1))

    (rl, ra), rg = jax.value_and_grad(ref_loss, has_aux=True)(
        [jnp.asarray(w) for w in ws], jnp.asarray(spikes),
        jnp.asarray(labels), rcfg)
    leaves = [w.clone().requires_grad_(True) for w in tp]
    pl, pa = snn_loss(leaves, torch.from_numpy(spikes),
                      torch.from_numpy(labels), pcfg)
    pg = torch.autograd.grad(pl, leaves)
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)
    assert pa.item() == float(ra)
    assert_grads_close(rg, pg, ctx="mlp")


# ------------------------------------------------------------ conv twins

CONV_CASES = [((2, 8, 8), (4, 8), 10, 8, 0.3, 1.5, 1, 1, 2, ()),
              ((2, 9, 9), (3,), 6, 5, 0.4, 2.0, 2, 0, 1, (12,)),
              ((1, 12, 12), (4, 4), 7, 4, 0.3, 1.5, 1, 1, 3, ())]


def _conv_cfgs(in_shape, ch, t, stride, pad, pool, hidden):
    kw = dict(in_shape=in_shape, conv_channels=ch, stride=stride,
              padding=pad, pool=pool, dense_hidden=hidden, num_steps=t)
    return RefConvCfg(**kw), ConvSNNConfig(**kw)


@pytest.mark.parametrize(
    "in_shape,ch,t,b,p,gain,stride,pad,pool,hidden", CONV_CASES)
def test_conv_forward_loss_grads_match_reference(in_shape, ch, t, b, p, gain,
                                                 stride, pad, pool, hidden):
    """``F.conv2d`` for ``lax.conv_general_dilated`` (NCHW/OIHW, so the
    kernels cross unchanged), the crop-reshape-sum pool for
    ``reduce_window`` (a window of 3 on a 9- or 12-wide map, and no pool),
    through the same LIF per mapped layer.  A kernel tap's gradient sums
    over every output position, sample and step, terms of either sign two
    to three orders above the result, so its floor is 1e-5 max|g| (the
    dense leaves' summations are shorter)."""
    rng = np.random.default_rng(sum(ch))
    rcfg, pcfg = _conv_cfgs(in_shape, ch, t, stride, pad, pool, hidden)
    ws = [np.asarray(w) * gain for w in ref_init_conv(jax.random.key(2),
                                                      rcfg)]
    spikes = _raster(rng, t, b, pcfg.n_in, p)
    labels = rng.integers(0, 10, b)
    rc, ro = ref_conv_forward([jnp.asarray(w) for w in ws],
                              jnp.asarray(spikes), rcfg)
    tp = params_from_reference(ws, "cpu")
    pc, po = conv_snn_forward(tp, torch.from_numpy(spikes), pcfg)
    assert po.shape == (t, b, 10)
    vm = oracle_membranes(ref_layer_specs(ws, rcfg), pcfg.lif, spikes)[-1]
    assert_spikes_match(np.asarray(ro), _np(po), vm, 1.0, ctx="conv output")
    (rl, ra), rg = jax.value_and_grad(ref_conv_loss, has_aux=True)(
        [jnp.asarray(w) for w in ws], jnp.asarray(spikes),
        jnp.asarray(labels), rcfg)
    leaves = [w.clone().requires_grad_(True) for w in tp]
    pl, pa = conv_snn_loss(leaves, torch.from_numpy(spikes),
                           torch.from_numpy(labels), pcfg)
    pg = torch.autograd.grad(pl, leaves)
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)
    assert pa.item() == float(ra)
    assert_grads_close(rg, pg, atol_frac=1e-5, ctx="conv")


def test_layer_specs_match_reference_and_training_forward():
    """Twin of tests/test_conv.py::test_layer_specs_match_training_forward:
    the port's lowered stack equals the reference's spec for spec, and
    the port's ``reference_forward`` over it computes the port's training
    graph."""
    kw = dict(in_shape=(2, 8, 8), conv_channels=(4, 6), num_steps=6)
    rcfg = RefConvCfg(lif=RefLIF(beta=0.8, threshold=0.7), **kw)
    pcfg = ConvSNNConfig(lif=LIFParams(beta=0.8, threshold=0.7), **kw)
    ws = [np.asarray(w) for w in ref_init_conv(jax.random.key(0), rcfg)]
    ref_specs = ref_layer_specs(ws, rcfg)
    specs = layer_specs(params_from_reference(ws, "cpu"), pcfg)
    assert [type(s).__name__ for s in specs] == \
        ["Conv2d", "Conv2d", "Conv2d", "Conv2d", "Dense"]
    for r, s in zip(ref_specs, specs):
        assert type(r).__name__ == type(s).__name__
        np.testing.assert_array_equal(s.stored_weights, r.stored_weights)
        if isinstance(s, Conv2d):
            assert (s.in_shape, s.stride, s.padding, s.out_shape) == \
                (r.in_shape, r.stride, r.padding, r.out_shape)
        np.testing.assert_array_equal(s.unroll(), r.unroll())
    rng = np.random.default_rng(1)
    spikes = _raster(rng, 6, 3, pcfg.n_in, 0.3)
    _, outs = conv_snn_forward(params_from_reference(ws, "cpu"),
                               torch.from_numpy(spikes), pcfg)
    for b in range(3):
        ref = reference_forward(specs, pcfg.lif, spikes[:, b])
        np.testing.assert_allclose(_np(outs[:, b]), ref, atol=1e-5)


# ------------------------------------------------- tests/test_snn.py twins

DATA = dict(num_steps=15, base_rate=0.02, signal_rate=0.5)
SIZES = (128, 48, 24, 10)


@pytest.fixture(scope="module")
def trained():
    """The reference's test_snn fixture (its data, its 150-step training)
    and the port's own training on the same data and batch draws."""
    cfg_d = RefData("tiny", 8, 8, **DATA)
    spikes, labels = ref_dataset(cfg_d, n_per_class=24, key=jax.random.key(0))
    rcfg = RefSNNCfg(layer_sizes=(cfg_d.n_in, 48, 24, 10), num_steps=15)
    rparams, _ = ref_train(
        REF_MLP, rcfg, ref_event_batches(spikes, labels, batch=32),
        RefTrainConfig(steps=150, lr=2e-3, log_every=1000),
        key=jax.random.key(1), log_fn=_quiet)
    pcfg = SNNConfig(layer_sizes=rcfg.layer_sizes, num_steps=15)
    pparams, hist = train_snn_model(
        MLP_MODEL, pcfg, event_batches(spikes, labels, batch=32),
        SNNTrainConfig(steps=150, lr=2e-3, log_every=1000),
        key=torch.Generator().manual_seed(1), device="cpu", log_fn=_quiet)
    return dict(rcfg=rcfg, pcfg=pcfg, spikes=spikes, labels=labels,
                rparams=[np.asarray(w) for w in rparams], pparams=pparams,
                hist=hist)


def _ref_accuracy(params, cfg, spikes, labels):
    counts, _ = ref_forward([jnp.asarray(w) for w in params],
                            jnp.asarray(spikes.swapaxes(0, 1)), cfg)
    return float((np.asarray(counts).argmax(-1) == labels).mean())


def _accuracy(params, cfg, spikes, labels):
    counts, _ = snn_forward(params, torch.from_numpy(
        np.ascontiguousarray(spikes.swapaxes(0, 1))), cfg)
    return float((_np(counts).argmax(-1) == labels).mean())


def test_port_accuracy_on_reference_weights_equals_reference(trained):
    """On the reference's trained weights, before and after its 50 % L1
    prune and 8-bit quantization, the port classifies every clip as the
    reference does: the same ``acc0`` and ``acc1``."""
    t = trained
    rw, sp, lb = t["rparams"], t["spikes"], t["labels"]
    acc0_ref = _ref_accuracy(rw, t["rcfg"], sp, lb)
    _, rdq = ref_quantize(ref_prune([jnp.asarray(w) for w in rw], 0.5)[0])
    acc1_ref = _ref_accuracy([np.asarray(w) for w in rdq], t["rcfg"], sp, lb)
    tp = params_from_reference(rw, "cpu")
    pruned, _ = prune_pytree(tp, 0.5)
    _, dq = quantize_pytree(pruned)
    for a, b in zip(dq, rdq):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _accuracy(tp, t["pcfg"], sp, lb) == acc0_ref
    assert _accuracy(dq, t["pcfg"], sp, lb) == acc1_ref


def test_training_beats_chance(trained):
    t = trained
    assert len(t["hist"]["loss"]) == 150
    acc = _accuracy(t["pparams"], t["pcfg"], t["spikes"], t["labels"])
    assert acc > 0.5, f"accuracy {acc} barely above chance"


def test_prune_quantize_small_drop(trained):
    """Algorithm 1 step 2 on the port's own trained model: the accuracy
    drop after 50 % L1 prune + 8-bit PTQ stays under the reference test's
    0.10 bound (paper: 94.75 -> 94.1, 65.38 -> 65.03)."""
    t = trained
    acc0 = _accuracy(t["pparams"], t["pcfg"], t["spikes"], t["labels"])
    pruned, _ = prune_pytree(t["pparams"], 0.5)
    _, dq = quantize_pytree(pruned)
    acc1 = _accuracy(dq, t["pcfg"], t["spikes"], t["labels"])
    assert sparsity(pruned) > 0.45
    assert acc0 - acc1 < 0.10, f"{acc0} -> {acc1}"


def test_full_flow_on_accelerator(trained):
    """Algorithm 1 end to end on the port: the mapped accelerator (the
    port's batched engine, bit-exact with its numpy oracle) classifies like
    the quantized SNN."""
    t = trained
    pruned, _ = prune_pytree(t["pparams"], 0.5)
    _, dq = quantize_pytree(pruned)
    spec = AcceleratorSpec("flow", n_cores=3, n_engines=8, n_caps=8,
                           weight_mem_bytes=1 << 22)
    model = map_model([_np(w) for w in dq], spec, lif=t["pcfg"].lif,
                      quant_bits=8)
    n = 16
    clips = t["spikes"][:n]
    oracle = run_batch(model, clips)
    res = br.run_batched(model, clips, device="cpu")
    for b, o in enumerate(oracle):
        np.testing.assert_array_equal(res.out_spikes[b], o.out_spikes,
                                      err_msg=f"sample {b}")
        for li, (bs, os_) in enumerate(zip(res.sample_stats(b),
                                           o.per_layer_stats)):
            np.testing.assert_array_equal(bs.engine_ops, os_.engine_ops)
            np.testing.assert_array_equal(bs.cycles, os_.cycles)
    preds = np.array([o.out_spikes.sum(axis=0).argmax() for o in oracle])
    acc_hw = float((preds == t["labels"][:n]).mean())
    acc_ref = _accuracy(dq, t["pcfg"], clips, t["labels"][:n])
    assert abs(acc_hw - acc_ref) <= 0.25
    assert acc_hw > 0.3


# ------------------------------------------------ tests/test_conv.py twin

def test_trained_conv_model_bit_exact_batch():
    """Twin of tests/test_conv.py::test_trained_conv_model_bit_exact_batch
    on the port: a trained 2-conv + dense-head model maps via map_model and
    the port's batched engine equals the port's oracle for every sample of
    a batch of 8."""
    data = EventDatasetConfig.cifar10_dvs_like(down=16)   # 2 x 8 x 8
    cfg = ConvSNNConfig(in_shape=(2, 8, 8), conv_channels=(4, 8),
                        num_steps=10)
    spikes, labels = synthetic_event_dataset(data, n_per_class=3,
                                             rng=np.random.default_rng(0))
    spikes = np.ascontiguousarray(spikes[:, :cfg.num_steps])
    params, hist = train_snn_model(
        CONV_MODEL, cfg, event_batches(spikes, labels, batch=8),
        SNNTrainConfig(steps=6, log_every=1000),
        key=torch.Generator().manual_seed(1), device="cpu", log_fn=_quiet)
    assert np.isfinite(hist["loss"][-1])
    pruned, _ = prune_pytree(params, 0.5)
    specs = layer_specs(pruned, cfg)
    assert sum(isinstance(s, Conv2d) for s in specs) >= 2
    spec = AcceleratorSpec("test", n_cores=8, n_engines=4, n_caps=8,
                           weight_mem_bytes=1 << 16)
    model = map_model(specs, spec, lif=cfg.lif)
    assert any(len(layer.rounds) > 1 for layer in model.layers), \
        "stack should exercise multi-round conv mapping"
    batch = spikes[:8]
    res = br.run_batched(model, batch, device="cpu")
    for b, oracle in enumerate(run_batch(model, batch)):
        np.testing.assert_array_equal(res.out_spikes[b], oracle.out_spikes,
                                      err_msg=f"sample {b}")
        for li, (bs, os_) in enumerate(zip(res.sample_stats(b),
                                           oracle.per_layer_stats)):
            np.testing.assert_array_equal(bs.engine_ops, os_.engine_ops,
                                          err_msg=f"sample {b} layer {li}")
            np.testing.assert_array_equal(bs.cycles, os_.cycles,
                                          err_msg=f"sample {b} layer {li}")


# ------------------------------------------------ tests/test_noise.py twin

def test_snn_accuracy_degrades_gracefully():
    """C2C gain error <= 2 % costs little accuracy; 80 % destroys it — the
    robustness story for the analog path, on the port's trainer and its
    ``perturb_weights`` with a ``torch.Generator``."""
    cfg_d = EventDatasetConfig("noise", 8, 8, num_steps=12, base_rate=0.02,
                               signal_rate=0.5)
    snn = SNNConfig(layer_sizes=(cfg_d.n_in, 32, 10), num_steps=12)
    spikes, labels = synthetic_event_dataset(cfg_d, 12,
                                             np.random.default_rng(0))
    params, _ = train_snn_model(
        MLP_MODEL, snn, event_batches(spikes, labels, 32),
        SNNTrainConfig(steps=120, log_every=1000),
        key=torch.Generator().manual_seed(1), device="cpu", log_fn=_quiet)
    base = _accuracy(params, snn, spikes, labels)

    def noisy(sigma, seed):
        gen = torch.Generator().manual_seed(seed)
        return [perturb_weights(gen, w, AnalogNoise(weight_sigma=sigma))
                for w in params]

    small = np.mean([_accuracy(noisy(0.02, s), snn, spikes, labels)
                     for s in range(3)])
    large = np.mean([_accuracy(noisy(0.8, s), snn, spikes, labels)
                     for s in range(3)])
    assert small > base - 0.15
    assert large < small
