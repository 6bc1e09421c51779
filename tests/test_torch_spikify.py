"""Spikified linear execution in the port: the reference's laws
(unbiasedness, 1/sqrt(T) convergence, events tracking activation sparsity)
on the port's own generator; the reference's frames, reproduced here from
its JAX key, through the port's event path against the reference's result;
and the port's one-launch fold equal to a per-frame loop, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import spikify
from repro_torch.core.spikify import (accumulate_frames, rate_scale,
                                      spikified_ffn, spikified_linear)
from repro_torch.kernels import event_synapse as es
from repro_torch.kernels import ops


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_spikified_linear_converges(rng):
    x = _t(np.abs(rng.normal(size=(4, 64))).astype(np.float32))
    w = _t(rng.normal(size=(64, 32)).astype(np.float32))
    want = (x @ w).numpy()
    errs = []
    for t in (8, 128):
        y, _ = spikified_linear(_gen(0), x, w, num_steps=t)
        errs.append(float(np.abs(y.numpy() - want).mean()))
    assert errs[1] < errs[0] * 0.5         # ~1/sqrt(16) = 4x expected
    assert errs[1] < 0.25 * float(np.abs(want).mean())


def test_event_fraction_tracks_sparsity(rng):
    w = _t(rng.normal(size=(64, 32)).astype(np.float32))
    dense_x = np.abs(rng.normal(size=(4, 64))).astype(np.float32)
    sparse_x = dense_x * (rng.random((4, 64)) < 0.1)
    _, s_dense = spikified_linear(_gen(1), _t(dense_x), w, num_steps=16)
    _, s_sparse = spikified_linear(_gen(1), _t(sparse_x.astype(np.float32)),
                                   w, num_steps=16)
    assert float(s_sparse["event_fraction"]) < \
        float(s_dense["event_fraction"]) * 0.5


def test_spikified_ffn_runs(rng):
    x = _t(rng.normal(size=(2, 32)).astype(np.float32))
    w_in = _t(rng.normal(size=(32, 64)).astype(np.float32) * 0.3)
    w_out = _t(rng.normal(size=(64, 16)).astype(np.float32) * 0.3)
    y, stats = spikified_ffn(_gen(2), x, w_in, w_out, num_steps=64)
    want = (torch.relu(x @ w_in) @ w_out).numpy()
    got = y.numpy()
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9
    assert stats["dense_equiv_events"] == 64 * 2 * 64


def _reference_frames(key, x, num_steps, x_max=None):
    """The reference's rates and frames for ``key``, drawn here the way its
    scan draws them (one split key per frame)."""
    xj = jnp.asarray(x)
    if x_max is None:
        x_max = jnp.maximum(jnp.max(xj), 1e-6)
    rates = jnp.clip(xj / x_max, 0.0, 1.0)
    frames = [np.asarray(jax.random.uniform(k, xj.shape) < rates,
                         dtype=np.float32)
              for k in jax.random.split(key, num_steps)]
    return np.asarray(rates), np.stack(frames), np.float32(x_max)


@pytest.mark.parametrize("num_steps,max_events,x_max,sparsity", [
    (8, None, None, 0.0), (32, None, None, 0.6), (16, 20, None, 0.0),
    (12, None, 2.5, 0.3), (5, 7, 0.75, 0.5)])
def test_spikified_linear_matches_reference_on_its_frames(
        monkeypatch, num_steps, max_events, x_max, sparsity):
    """The reference's ``spikified_linear`` with its dense Pallas kernel
    swapped for ``ref.event_synapse_ref`` (the kernel cannot trace on this
    JAX), against the port's event path on the same frames.  Rates and
    ``x_max`` equal bit for bit, event counts exactly; ``y`` within twice
    the float32 rounding bound of the ``n_in + T``-term sums taken in
    another order (``event_synapse_ref`` sums a row with ``jnp.sum``)."""
    import repro.kernels.ops as ref_ops
    from repro.core.spikify import spikified_linear as ref_spikified_linear
    from repro.kernels.ref import event_synapse_ref
    monkeypatch.setattr(ref_ops, "event_synapse", event_synapse_ref)

    rng = np.random.default_rng(num_steps)
    n_in, n_out = 48, 24
    x = np.abs(rng.normal(size=(3, n_in))).astype(np.float32)
    x[rng.random(x.shape) < sparsity] = 0
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    key = jax.random.key(num_steps)
    y_ref, st_ref = ref_spikified_linear(key, jnp.asarray(x), jnp.asarray(w),
                                         num_steps=num_steps, x_max=x_max,
                                         max_events=max_events)
    rates, frames, xm = _reference_frames(key, x, num_steps, x_max)

    p_rates, p_xmax = rate_scale(_t(x), x_max)
    assert torch.equal(p_rates, _t(rates))
    assert float(p_xmax) == float(xm)
    acc, n_events = accumulate_frames(_t(frames), _t(w), max_events)
    y = acc / spikify._f32(num_steps, acc.device) * p_xmax
    assert int(n_events) == int(st_ref["events"])
    assert float(n_events / (num_steps * 3 * n_in)) == \
        float(st_ref["event_fraction"])
    counts = frames.sum(axis=0)
    if max_events is not None:                 # events past the depth drop
        counts = np.stack([
            sum(np.where(np.cumsum(f[b]) <= max_events, f[b], 0)
                for f in frames) for b in range(3)])
    bound = (2 * (n_in + num_steps) * 2.0 ** -24
             * (counts @ np.abs(w)) * xm / num_steps)
    err = np.abs(y.numpy() - np.asarray(y_ref))
    assert (err <= bound).all(), (err.max(), bound.max())


@pytest.mark.parametrize("t,b,n_in,n_out,max_events,p", [
    (1, 1, 16, 8, None, 0.5), (7, 3, 64, 33, None, 0.2),
    (16, 4, 200, 40, 25, 0.3), (9, 2, 300, 7, None, 0.02),
    (4, 5, 128, 64, None, 1.0)])
def test_fold_equals_per_frame_loop(t, b, n_in, n_out, max_events, p):
    """One launch over all ``T * B`` rows, then a sequential fold over T,
    equals the reference's per-frame scan (one launch a frame, ``acc +
    cur``) bit for bit on the CPU path; the event count too."""
    rng = np.random.default_rng(n_in)
    frames = _t((rng.random((t, b, n_in)) < p).astype(np.float32))
    w = _t(rng.normal(size=(n_in, n_out)).astype(np.float32))
    depth = n_in if max_events is None else max_events
    acc = torch.zeros(b, n_out)
    n = 0
    for step in range(t):
        ev = ops.events_from_spikes(frames[step], depth)
        acc = acc + es.event_synapse_plain(ev, w)
        n += int((ev >= 0).sum())
    got, n_events = accumulate_frames(frames, w, max_events)
    assert torch.equal(got, acc)
    assert int(n_events) == n
    assert n_events.dtype == torch.int64


def test_spikified_linear_stats_and_reproducibility(rng):
    x = _t(np.abs(rng.normal(size=(5, 40))).astype(np.float32))
    w = _t(rng.normal(size=(40, 12)).astype(np.float32))
    y, st = spikified_linear(_gen(3), x, w, num_steps=10)
    y2, st2 = spikified_linear(_gen(3), x, w, num_steps=10)
    assert torch.equal(y, y2) and int(st["events"]) == int(st2["events"])
    assert st["dense_equiv_events"] == 10 * 5 * 40
    assert float(st["event_fraction"]) == \
        float(np.float32(int(st["events"])) / np.float32(2000))
    # every event of a frame is a source whose rate drew a spike: the
    # expected count is T * sum(rates)
    rates, _ = rate_scale(x)
    want = 10 * float(rates.sum())
    assert abs(int(st["events"]) - want) < 5 * np.sqrt(want)


def test_rate_scale_edges():
    rates, x_max = rate_scale(torch.zeros(2, 3))
    assert float(x_max) == float(np.float32(1e-6))
    assert torch.equal(rates, torch.zeros(2, 3))
    x = torch.tensor([[0.5, 2.0, -1.0]])
    rates, x_max = rate_scale(x, 1.0)
    assert torch.equal(rates, torch.tensor([[0.5, 1.0, 0.0]]))
    assert x_max.dtype == torch.float32 and x_max.dim() == 0


def test_spikified_ffn_first_product_is_float32_relu(rng):
    """``spikified_ffn`` feeds ``relu(x @ w_in)`` to ``spikified_linear``:
    with the same generator both give the same result."""
    x = _t(rng.normal(size=(3, 16)).astype(np.float32))
    w_in = _t(rng.normal(size=(16, 32)).astype(np.float32))
    w_out = _t(rng.normal(size=(32, 8)).astype(np.float32))
    y, st = spikified_ffn(_gen(4), x, w_in, w_out, num_steps=6)
    y2, st2 = spikified_linear(_gen(4), torch.relu(x @ w_in), w_out,
                               num_steps=6)
    assert torch.equal(y, y2)
    assert int(st["events"]) == int(st2["events"])
