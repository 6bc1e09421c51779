"""The port's training loop (``repro_torch.engine.train_loop``): twins of
tests/test_train_loop.py on the same toy regression, held against the
reference's trajectory where both packages train."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.engine.train_loop import TrainLoopConfig as RefLoop
from repro.engine.train_loop import init_train_state as ref_init_state
from repro.engine.train_loop import make_train_step as ref_make_step
from repro.engine.train_loop import train_loop as ref_train_loop
from repro.optim.adamw import AdamWConfig as RefAdamW

from repro_torch.engine.train_loop import (TrainLoopConfig, init_train_state,
                                           make_train_step, resume_or_init,
                                           train_loop)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import CompressionConfig


def _toy_data(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(8, 4)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    return x, x @ w_true


def _idx(step):
    return np.random.default_rng(step).integers(0, 64, 16)


def _toy_problem(seed=0):
    x, y = _toy_data(seed)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    def batch_fn(step):
        i = _idx(step)
        return {"x": torch.from_numpy(x[i]), "y": torch.from_numpy(y[i])}

    return loss_fn, batch_fn, {"w": torch.zeros((8, 4))}


def _ref_toy_problem(seed=0):
    x, y = _toy_data(seed)

    def loss_fn(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    def batch_fn(step):
        i = _idx(step)
        return {"x": jnp.asarray(x[i]), "y": jnp.asarray(y[i])}

    return loss_fn, batch_fn, {"w": jnp.zeros((8, 4))}


def _quiet(s):
    pass


def test_loss_decreases_like_reference(tmp_path):
    """Twin of test_loss_decreases.  The first loss is the same mean square
    on the same batch (rtol 1e-6); the trajectories stay within rtol 1e-4
    for 5 steps — beyond that Adam's sign-like steps on near-zero
    gradients amplify float32 noise, so later steps are held only to the
    convergence criterion."""
    loss_fn, batch_fn, params = _toy_problem()
    opt_cfg = AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=1)
    state = init_train_state(None, params, opt_cfg)
    cfg = TrainLoopConfig(steps=60, checkpoint_every=1000,
                          checkpoint_dir=str(tmp_path), log_every=1000)
    _, hist = train_loop(state.as_tree(), make_train_step(loss_fn, opt_cfg),
                         batch_fn, cfg, log_fn=_quiet)
    assert hist["loss"][-1] < hist["loss"][0] * 0.2
    assert len(hist["grad_norm"]) == len(hist["lr"]) == 60

    rl, rb, rp = _ref_toy_problem()
    rcfg = RefAdamW(lr=3e-2, weight_decay=0.0, warmup_steps=1)
    _, rhist = ref_train_loop(
        ref_init_state(None, rp, rcfg).as_tree(),
        jax.jit(ref_make_step(rl, rcfg)), rb,
        RefLoop(steps=5, checkpoint_dir=None, log_every=1000), log_fn=_quiet)
    np.testing.assert_allclose(hist["loss"][:5], rhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["loss"][0], rhist["loss"][0], rtol=1e-6)


def test_checkpoint_restart_exactly_once(tmp_path):
    """Kill at step 27, restart from the step-25 checkpoint: the final state
    equals the uninterrupted run's bit for bit."""
    loss_fn, batch_fn, params = _toy_problem()
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    step = make_train_step(loss_fn, opt_cfg)

    def fresh():
        return init_train_state(None, params, opt_cfg).as_tree()

    cfg = TrainLoopConfig(steps=40, checkpoint_every=5,
                          checkpoint_dir=str(tmp_path / "ab"),
                          log_every=1000)
    ref, _ = train_loop(fresh(), step, batch_fn,
                        TrainLoopConfig(steps=40, checkpoint_every=1000,
                                        checkpoint_dir=None, log_every=1000),
                        log_fn=_quiet)

    class Boom(RuntimeError):
        pass

    def bomb(s):
        if s == 27:
            raise Boom()

    try:
        train_loop(fresh(), step, batch_fn, cfg, failure_hook=bomb,
                   log_fn=_quiet)
        raise AssertionError("should have failed")
    except Boom:
        pass
    state, start = resume_or_init(cfg, fresh(), device="cpu")
    assert start == 25
    final, hist = train_loop(state, step, batch_fn, cfg, start_step=start,
                             log_fn=_quiet)
    assert len(hist["loss"]) == 15
    assert torch.equal(final["params"]["w"], ref["params"]["w"])
    assert int(final["opt"]["step"]) == 40


def test_straggler_detection(tmp_path):
    loss_fn, batch_fn, params = _toy_problem()
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    inner = make_train_step(loss_fn, opt_cfg)
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 20:
            time.sleep(0.5)                     # injected straggler
        return inner(state, batch)

    cfg = TrainLoopConfig(steps=30, checkpoint_every=1000,
                          checkpoint_dir=str(tmp_path), log_every=1000)
    state = init_train_state(None, params, opt_cfg)
    logs = []
    _, hist = train_loop(state.as_tree(), step, batch_fn, cfg,
                         log_fn=logs.append)
    assert hist["stragglers"] >= 1
    assert any("[straggler] step 19" in s for s in logs)


def test_gradient_compression_error_feedback():
    """Compressed+EF gradients converge close to exact."""
    loss_fn, batch_fn, params = _toy_problem()
    opt_cfg = AdamWConfig(lr=3e-2, weight_decay=0.0, warmup_steps=1)
    comp = CompressionConfig(enabled=True, block=64)
    step_c = make_train_step(loss_fn, opt_cfg, comp)
    step_e = make_train_step(loss_fn, opt_cfg)
    sc = init_train_state(None, params, opt_cfg, comp).as_tree()
    se = init_train_state(None, params, opt_cfg).as_tree()
    assert "residual" in sc and "residual" not in se
    for s in range(100):
        b = batch_fn(s)
        sc, mc = step_c(sc, b)
        se, me = step_e(se, b)
    assert float(mc["loss"]) < 0.05
    assert abs(float(mc["loss"]) - float(me["loss"])) < 0.01


def test_microbatched_grads_match_full():
    """Gradient accumulation (K microbatches) == full-batch gradients, and
    the microbatched step matches the reference's on the same batch."""
    loss_fn, batch_fn, params = _toy_problem()
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    full = make_train_step(loss_fn, opt_cfg)
    micro = make_train_step(loss_fn, opt_cfg, microbatches=4)
    s1 = init_train_state(None, params, opt_cfg).as_tree()
    s2 = init_train_state(None, params, opt_cfg).as_tree()
    b = batch_fn(0)
    s1, m1 = full(s1, b)
    s2, m2 = micro(s2, b)
    np.testing.assert_allclose(s1["params"]["w"].numpy(),
                               s2["params"]["w"].numpy(), atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    rl, rb, rp = _ref_toy_problem()
    rcfg = RefAdamW(lr=1e-2, weight_decay=0.0, warmup_steps=1)
    rs, rm = jax.jit(ref_make_step(rl, rcfg, microbatches=4))(
        ref_init_state(None, rp, rcfg).as_tree(), rb(0))
    np.testing.assert_allclose(float(m2["loss"]), float(rm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(s2["params"]["w"].numpy(),
                               np.asarray(rs["params"]["w"]), atol=1e-6)
