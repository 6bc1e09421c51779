"""The port's analog non-ideality models (core/noise.py).

The port cannot draw JAX's random numbers, so it is held to the reference
two ways: the reference's own perturbed effective weights are carried into
the port (``convert.packed_with_tiles``) and served there, bit-exact
against the port's CPU path and the numpy oracle's accumulation order; and
the port's own noise is held to the reference's contracts — a ``(seed,
sigma)`` names one reproducible device instance, zeros stay zero, sigma 0
is the identity — as tests/test_noise.py holds the reference.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.accelerator import lif_rollout_np
from repro.core.noise import AnalogNoise as RefNoise
from repro.core.noise import perturb_packed as ref_perturb_packed
from repro.engine import batched_run as ref_br
from repro.launch.serve_snn import build_demo_model as ref_build

from repro_torch.convert import packed_with_tiles
from repro_torch.core.noise import (AnalogNoise, as_noise_key, perturb_beta,
                                    perturb_membrane, perturb_packed,
                                    perturb_weights)
from repro_torch.engine import (BucketPolicy, StreamServer, VirtualClock,
                                run_batched, run_bucketed, serve_trace)
from repro_torch.launch.serve_snn import build_demo_model

torch.set_num_threads(1)


def _tiles(packed):
    return [l.w_fused.numpy() for l in packed.layers]


def test_zero_noise_is_identity():
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    assert perturb_weights(as_noise_key(0), w, AnalogNoise()) is w
    assert perturb_membrane(as_noise_key(0), w, AnalogNoise()) is w
    assert torch.equal(perturb_beta(as_noise_key(0), 0.9, (3,),
                                    AnalogNoise()), torch.full((3,), 0.9))


def test_weight_noise_magnitude():
    w = torch.ones(64, 64)
    w2 = perturb_weights(as_noise_key(0), w, AnalogNoise(weight_sigma=0.05))
    assert 0.03 < float((w2 - w).std()) < 0.07
    v = perturb_membrane(as_noise_key(1), torch.zeros(64, 64),
                         AnalogNoise(offset_sigma=0.1))
    assert 0.07 < float(v.std()) < 0.13
    b = perturb_beta(as_noise_key(2), 0.95, (4096,),
                     AnalogNoise(leak_mismatch=0.5))
    assert float(b.min()) >= 0.0 and float(b.max()) == 1.0


def test_as_noise_key():
    g = torch.Generator().manual_seed(5)
    assert as_noise_key(g) is g
    assert as_noise_key(5).initial_seed() == 5
    assert as_noise_key(np.int64(5)).initial_seed() == 5
    with pytest.raises(TypeError):
        as_noise_key("5")


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_perturb_packed_is_a_deterministic_device_instance(kind):
    """Same seed -> bit-identical model, whatever was drawn before or from
    a generator given in place of the int; another seed -> another
    instance; sigma 0 -> the same object; absent synapses stay zero."""
    packed = build_demo_model(kind, smoke=True).pack(device="cpu")
    n = AnalogNoise(weight_sigma=0.05)
    a = perturb_packed(7, packed, n)
    torch.randn(1000)                               # global draws between
    used = torch.Generator().manual_seed(7)
    torch.randn(10, generator=used)                 # a consumed generator
    for b in (perturb_packed(7, packed, n), perturb_packed(used, packed, n)):
        for wa, wb in zip(_tiles(a), _tiles(b)):
            np.testing.assert_array_equal(wa, wb)
    other = perturb_packed(8, packed, n)
    assert any(not np.array_equal(wa, wo)
               for wa, wo in zip(_tiles(a), _tiles(other)))
    assert perturb_packed(7, packed, AnalogNoise()) is packed
    for w0, wa in zip(_tiles(packed), _tiles(a)):
        np.testing.assert_array_equal(wa == 0, w0 == 0)
        assert not np.array_equal(wa, w0)
    assert a.input_buffers == {} and a.device == packed.device


def test_perturb_packed_refuses_packed_operands():
    packed = build_demo_model("mlp", smoke=True).pack(packed_ops=True,
                                                      device="cpu")
    with pytest.raises(ValueError, match="packed sub-byte operands"):
        perturb_packed(0, packed, AnalogNoise(weight_sigma=0.05))


def test_run_bucketed_noise_injection_is_reproducible(rng):
    model = build_demo_model("mlp", smoke=True).pack(device="cpu")
    streams = [(rng.random((t, 64)) < 0.3).astype(np.float32)
               for t in (4, 9, 6, 3)]
    kw = dict(policy=BucketPolicy(batch_sizes=(2, 4), time_steps=(10,)),
              with_stats=False)
    noise = AnalogNoise(weight_sigma=0.08)
    clean = run_bucketed(model, streams, **kw)
    n1 = run_bucketed(model, streams, noise=noise, noise_key=3, **kw)
    n2 = run_bucketed(model, streams, noise=noise, noise_key=3, **kw)
    for r1, r2 in zip(n1, n2):
        assert np.array_equal(r1.out_spikes, r2.out_spikes)
    assert any(not np.array_equal(c.out_spikes, r.out_spikes)
               for c, r in zip(clean, n1))
    for c, r in zip(clean, run_bucketed(model, streams, noise=None, **kw)):
        assert np.array_equal(c.out_spikes, r.out_spikes)


def _oracle(tiles, n_dests, lif, spikes):
    """The numpy oracle's arithmetic on given weight tiles: per step, each
    event's weight row added in ascending source order in float32, then
    LIF; returns the output spikes ``[B, T, n_out]``."""
    x = spikes
    for w, n_dest in zip(tiles, n_dests):
        b, t, _ = x.shape
        cur = np.zeros((b, t, w.shape[1]), np.float32)
        for i in range(b):
            for j in range(t):
                for s in np.nonzero(x[i, j])[0]:
                    cur[i, j] += w[s]
        x = np.stack([lif_rollout_np(cur[i], lif) for i in range(b)])
        x = x[..., :n_dest]
    return x


@pytest.mark.parametrize("kind,seed,sigma", [("mlp", 7, 0.05),
                                             ("mlp", 8, 0.2),
                                             ("conv", 7, 0.1)])
def test_reference_noisy_weights_serve_bit_exact(rng, kind, seed, sigma):
    """The reference's perturbed effective weights (its perturb_packed on
    its f32 replay, fused per layer) carried into the port: the port's
    engine, its bucketed front end and its StreamServer serve them
    bit-exactly as the numpy oracle's order does, and the tiles keep the
    port's clean tiles' sparsity."""
    ref_mapped = ref_build(kind, smoke=True)
    noisy = ref_perturb_packed(jax.random.key(seed),
                               ref_mapped.pack(packed_ops=False),
                               RefNoise(weight_sigma=sigma))
    tiles = [np.asarray(ref_br._layer_weights(l, noisy.weight_dict))
             for l in noisy.layers]
    clean = build_demo_model(kind, smoke=True).pack(device="cpu")
    for t, w0 in zip(tiles, _tiles(clean)):
        np.testing.assert_array_equal(t == 0, w0 == 0)
    port = packed_with_tiles(clean, tiles)
    spikes = (rng.random((3, 7, port.n_in)) < 0.3).astype(np.float32)
    want = _oracle(tiles, [l.n_dest for l in port.layers], ref_mapped.lif,
                   spikes)
    got = run_batched(port, spikes)
    np.testing.assert_array_equal(got.out_spikes, want)
    streams = [spikes[0], spikes[1, :4], spikes[2, :6]]
    policy = BucketPolicy(batch_sizes=(2,), time_steps=(8,))
    bucketed = run_bucketed(port, streams, policy=policy, with_stats=False)
    server = StreamServer(port, policy=policy, clock=VirtualClock(),
                          service_model=lambda b, t: 0.001)
    served, rids = serve_trace(server, [(0.01 * i, s)
                                        for i, s in enumerate(streams)])
    for i, s in enumerate(streams):
        np.testing.assert_array_equal(bucketed[i].out_spikes,
                                      want[i, :s.shape[0]])
        np.testing.assert_array_equal(served[rids[i]].out_spikes,
                                      want[i, :s.shape[0]])
    with pytest.raises(ValueError, match="tiles"):
        packed_with_tiles(clean, tiles[:1])


def test_noisy_server_serves_one_instance(rng):
    """A server built with noise serves the seed's noisy instance — equal
    to run_bucketed with the same (noise, key) — and shadow-probes the
    clean twin."""
    model = build_demo_model("mlp", smoke=True).pack(device="cpu")
    noise = AnalogNoise(weight_sigma=0.1)
    streams = [(rng.random((t, 64)) < 0.3).astype(np.float32)
               for t in (5, 7, 3, 8)]
    policy = BucketPolicy(batch_sizes=(2,), time_steps=(8,))
    server = StreamServer(model, policy=policy, clock=VirtualClock(),
                          noise=noise, noise_key=4, noise_probe_every=1,
                          service_model=lambda b, t: 0.001)
    assert server._clean_packed is model and server.packed is not model
    served, rids = serve_trace(server, [(0.0, s) for s in streams])
    want = run_bucketed(model, streams, policy=policy, with_stats=False,
                        noise=noise, noise_key=4)
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(served[rid].out_spikes, w.out_spikes)
    snap = server.metrics.snapshot()
    assert snap["noise_probes"] == 4 and 0.0 <= snap["noise_agreement"] <= 1
