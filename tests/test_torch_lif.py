"""The port's A-NEURON math against the reference package: the
surrogate-gradient spike function (a ``torch.autograd.Function``) and its
gradient through ``lif_rollout`` against ``jax.grad``, the rate encoder's
law, and the spike-count decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as ref_lif

from repro_torch.core import lif
from repro_torch.core.lif import LIFParams


def _ref_params(p: LIFParams):
    return ref_lif.LIFParams(beta=p.beta, threshold=p.threshold,
                             v_reset=p.v_reset,
                             surrogate_slope=p.surrogate_slope)


@pytest.mark.parametrize("threshold,slope", [(1.0, 25.0), (0.6, 5.0),
                                             (0.25, 100.0)])
def test_spike_fn_matches_reference(threshold, slope):
    v = np.random.default_rng(0).normal(threshold, 0.3, 257) \
        .astype(np.float32)
    v[:3] = [threshold, -10.0, 10.0]
    g = np.random.default_rng(1).normal(size=257).astype(np.float32)
    want_s = ref_lif.spike_fn(jnp.asarray(v), threshold, slope)
    want_g = jax.grad(lambda x: jnp.sum(
        ref_lif.spike_fn(x, threshold, slope) * g))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    s = lif.spike_fn(vt, threshold, slope)
    (s * torch.from_numpy(g)).sum().backward()
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(want_s))
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [
    LIFParams(beta=0.5, threshold=1.0),
    LIFParams(beta=0.25, threshold=0.6, v_reset=0.125, surrogate_slope=10.0),
    LIFParams(beta=1.0, threshold=0.8, surrogate_slope=50.0),
])
def test_spike_fn_gradient_through_lif_rollout_matches_jax(p):
    """d/dI of a weighted sum of spikes and voltages after a rollout: the
    surrogate, the reset's ``where`` and the leak, step by step through
    time, against ``jax.grad`` of the reference's rollout.  The decays and
    resets are powers of two, so ``beta * v`` is exact and the
    reference's contracted ``beta * v + I`` cannot move a voltage by an ulp
    (ROADMAP Queue 3 item 2): the forwards agree bit for bit.  The
    gradients agree to rtol 1e-6 with an absolute floor of 1e-7 (about an
    ulp of these O(1) gradients): the backward sums each step's terms in
    its own order, and where the sum over time cancels, one ulp of a term
    is a larger share of the result."""
    rng = np.random.default_rng(2)
    cur = rng.normal(0.35, 0.5, (12, 16)).astype(np.float32)
    cur = np.round(cur * 64) / 64                 # few mantissa bits
    ws = rng.normal(size=(12, 16)).astype(np.float32)
    wv = rng.normal(size=(12, 16)).astype(np.float32)
    rp = _ref_params(p)

    def ref_loss(c):
        s, v = ref_lif.lif_rollout(c, rp)
        return jnp.sum(s * ws) + jnp.sum(v * wv)

    want = jax.grad(ref_loss)(jnp.asarray(cur))
    ct = torch.from_numpy(cur).requires_grad_(True)
    s, v = lif.lif_rollout(ct, p)
    (s * torch.from_numpy(ws) + v * torch.from_numpy(wv)).sum().backward()
    s_ref, v_ref = ref_lif.lif_rollout(jnp.asarray(cur), rp)
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(v.detach().numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert np.abs(ct.grad.numpy()).max() > 0


def test_lif_gradient_flows_through_time():
    p = LIFParams(beta=0.9, threshold=1.0)

    def ref_loss(w):
        spikes, _ = ref_lif.lif_rollout(jnp.ones((5, 3)) * w, _ref_params(p))
        return spikes.sum()

    w = torch.tensor(0.4, requires_grad=True)
    spikes, _ = lif.lif_rollout(torch.ones(5, 3) * w, p)
    spikes.sum().backward()
    g = float(w.grad)
    assert np.isfinite(g) and abs(g) > 0
    np.testing.assert_allclose(g, float(jax.grad(ref_loss)(0.4)), rtol=1e-6)


def test_surrogate_gradient_nonzero_near_threshold():
    p = LIFParams()
    grads = []
    for x in (1.0, -10.0):
        v = torch.tensor([x], requires_grad=True)
        lif.spike_fn(v, p.threshold, p.surrogate_slope).sum().backward()
        grads.append(float(v.grad[0]))
    assert grads[0] > 0.1
    assert grads[1] < grads[0] * 1e-2


def test_spike_fn_gives_no_gradient_to_threshold_or_slope():
    v = torch.tensor([0.9, 1.1], requires_grad=True)
    th = torch.tensor(1.0, requires_grad=True)
    lif.spike_fn(v, th, 25.0).sum().backward()
    assert th.grad is None and v.grad is not None


@pytest.mark.parametrize("p", [LIFParams(), LIFParams(beta=0.3,
                                                      threshold=0.2,
                                                      v_reset=-0.1)])
def test_lif_step_forward_is_the_plain_formula(p):
    """``lif_step`` fires through ``spike_fn`` and its forward stays the
    float32 integrate / compare / reset, bit for bit."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.normal(0.5, 0.7, (6, 40)).astype(np.float32))
    i = torch.from_numpy(rng.normal(0.2, 0.5, (6, 40)).astype(np.float32))
    v_next, s = lif.lif_step(v, i, p)
    v_int = torch.tensor(p.beta, dtype=torch.float32) * v + i
    fired = v_int >= torch.tensor(p.threshold, dtype=torch.float32)
    assert torch.equal(s, fired.to(torch.float32))
    assert torch.equal(v_next, torch.where(
        fired, torch.tensor(p.v_reset, dtype=torch.float32), v_int))


def test_integrate_and_fire_waveform():
    p = LIFParams(beta=1.0, threshold=1.0, v_reset=0.0)
    spikes, vtrace = lif.lif_rollout(torch.full((10, 1), 0.3), p)
    s, v = spikes[:, 0].numpy(), vtrace[:, 0].numpy()
    assert s[0] == 0 and s[1] == 0 and s[2] == 0 and s[3] == 1
    assert v[3] == 0.0 and np.isclose(v[2], 0.9, atol=1e-6)
    want_s, want_v = ref_lif.lif_rollout(jnp.full((10, 1), 0.3),
                                         _ref_params(p))
    np.testing.assert_array_equal(s, np.asarray(want_s)[:, 0])


def test_reset_to_v_reset_value():
    p = LIFParams(beta=1.0, threshold=1.0, v_reset=0.25)
    v, s = lif.lif_step(torch.tensor([0.9]), torch.tensor([0.5]), p)
    assert s[0] == 1.0 and np.isclose(float(v[0]), 0.25)


@pytest.mark.parametrize("num_steps", [1, 7, 25, 64])
def test_spike_count_decode_matches_reference(num_steps):
    s = (np.random.default_rng(num_steps).random((num_steps, 5, 33)) < 0.3) \
        .astype(np.float32)
    got = lif.spike_count_decode(torch.from_numpy(s), num_steps)
    want = ref_lif.spike_count_decode(jnp.asarray(s), num_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_rate_encode_follows_its_law(seed):
    """Bernoulli frames of probability ``x``: shape ``[T, *x.shape]``,
    0/1 float32, each mean rate within 4 sigma of ``x``, and the same
    generator seed gives the same frames."""
    x = torch.tensor([[0.0, 0.1, 0.5], [0.9, 1.0, 0.02]])
    n = 4000
    gen = torch.Generator().manual_seed(seed)
    spikes = lif.rate_encode(x, n, gen)
    assert spikes.shape == (n, 2, 3) and spikes.dtype == torch.float32
    assert set(spikes.unique().tolist()) <= {0.0, 1.0}
    rates = spikes.mean(dim=0)
    sigma = torch.sqrt(x * (1 - x) / n)
    assert bool(((rates - x).abs() <= 4 * sigma + 1e-12).all()), rates
    again = lif.rate_encode(x, n, torch.Generator().manual_seed(seed))
    assert torch.equal(spikes, again)
