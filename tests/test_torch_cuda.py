"""The port's hand-written CUDA kernels and its engine on the card, held to
the plain PyTorch versions and the numpy oracle bit for bit.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither ``jax`` nor the reference package, so it also runs on
a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.accelerator import map_model, run
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.lif import LIFParams
from repro_torch.core.quant import pack_signmag
from repro_torch.engine import batched_run as br
from repro_torch.engine import (BucketPolicy, StreamServer, VirtualClock,
                                run_bucketed, serve_trace,
                                synth_arrival_trace)
from repro_torch.kernels import _build
from repro_torch.kernels import c2c_matmul as c2c
from repro_torch.kernels import event_synapse as es
from repro_torch.kernels import lif_update as lu
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _codes(rng, n_src, n_dest, bits):
    qmax = 2 ** (bits - 1) - 1
    return rng.integers(-qmax, qmax + 1, (n_src, n_dest)).astype(np.int8)


def _pruned_mlp(rng, sizes, gain=1.5):
    ws = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = rng.normal(0, gain / np.sqrt(a), (a, b)).astype(np.float32)
        w[np.abs(w) < np.median(np.abs(w))] = 0
        ws.append(w)
    return ws


@pytest.mark.parametrize("n_src,n_dest,max_ev", [
    (16, 128, 16), (700, 1000, 700), (2048, 1024, 300), (33, 7, 5),
    (1500, 130, 1500),
])
def test_cuda_event_synapse_matches_plain(card, n_src, n_dest, max_ev):
    rng = np.random.default_rng(n_src)
    w = _t(rng.normal(size=(n_src, n_dest)).astype(np.float32)).to(card)
    spikes = _t((rng.random((37, n_src)) < 0.3).astype(np.float32)).to(card)
    spikes[5] = 0                       # a silent row
    ev = ops.events_from_spikes(spikes, max_ev)
    assert torch.equal(es.event_synapse_cuda(ev, w),
                       es.event_synapse_plain(ev, w))
    for bits in (2, 4, 8):
        nd = n_dest - n_dest % (8 // bits)
        pk = _t(pack_signmag(_codes(rng, n_src, nd, bits), bits)).to(card)
        assert torch.equal(
            es.event_synapse_packed_cuda(ev, pk, 0.013, bits),
            es.event_synapse_packed_plain(ev, pk, 0.013, bits))


def test_cuda_event_synapse_rejects_what_it_cannot_take(card):
    ev = torch.full((4, 6), -1, dtype=torch.int32, device=card)
    w = torch.zeros(8, 16, device=card)
    with pytest.raises(ValueError, match="int32"):
        es.event_synapse_cuda(ev.long(), w)
    with pytest.raises(ValueError, match="contiguous"):
        es.event_synapse_cuda(ev[:, ::2], w)
    with pytest.raises(ValueError, match="weights"):
        es.event_synapse_cuda(ev, w.cpu())


def test_cuda_lif_matches_plain(card):
    rng = np.random.default_rng(3)
    cur = _t(rng.normal(0.4, 0.7, (5, 9, 300)).astype(np.float32)).to(card)
    p = LIFParams(beta=0.85, threshold=0.7, v_reset=0.1)
    assert torch.equal(lu.lif_scan_cuda(cur, p), lu.lif_scan_plain(cur, p))
    v, i = cur[:, 0].contiguous(), cur[:, 1].contiguous()
    got = lu.lif_update_cuda(v, i, beta=0.85, threshold=0.7, v_reset=0.1)
    want = lu.lif_update_plain(v, i, 0.85, 0.7, 0.1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("quant_bits", [8, 4])
def test_cuda_engine_matches_cpu_path_and_oracle(card, quant_bits):
    """run_batched and run_bucketed on the card equal the CPU path and the
    numpy oracle, dense and packed, and every kernel of the route ran."""
    rng = np.random.default_rng(quant_bits)
    sizes = (96, 64, 40, 10)
    spec = AcceleratorSpec("small", n_cores=len(sizes) - 1, n_engines=8,
                           n_caps=16, weight_mem_bytes=64 * 1024)
    mapped = map_model(_pruned_mlp(rng, sizes), spec,
                       quant_bits=quant_bits)
    spikes = (rng.random((3, 12, sizes[0])) < 0.3).astype(np.float32)
    want = br.run_batched(mapped.pack(device="cpu"), spikes)
    for packed_ops in (False, True):
        model = mapped.pack(packed_ops=packed_ops, device=card)
        _build.reset_launches()
        got = br.run_batched(model, spikes)
        synapse = "event_synapse_packed" if packed_ops else "event_synapse"
        assert _build.launches[synapse] == len(sizes) - 1
        assert _build.launches["lif_update"] == len(sizes) - 1
        np.testing.assert_array_equal(got.out_spikes, want.out_spikes)
        for b in range(spikes.shape[0]):
            for x, y in zip(got.sample_stats(b), want.sample_stats(b)):
                for f in ("cycles", "rows_touched", "engine_ops", "events",
                          "sn_bytes_touched"):
                    np.testing.assert_array_equal(getattr(x, f),
                                                  getattr(y, f))
    streams = [spikes[0, :12], spikes[1, :5], spikes[2, :9]]
    res = run_bucketed(mapped.pack(device=card), streams)
    for r, s in zip(res, streams):
        np.testing.assert_array_equal(r.out_spikes, run(mapped, s).out_spikes)


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (65, 33, 70), (130, 1500, 257), (256, 1024, 1024),
    (7, 9000, 129),
])
def test_cuda_c2c_matmul_matches_plain(card, m, k, n):
    """The kernel against ``(x @ w_q) * scale`` at ragged shapes (edges
    guarded, K split or not), every code -128..127 drawn, at the
    reference's tolerance; with 0/1 inputs and integer codes every partial
    sum is an integer below 2**24, so there the two agree bit for bit."""
    rng = np.random.default_rng(m * 7 + n)
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(card)
    w = _t(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(card)
    got = c2c.c2c_matmul_cuda(x, w, 0.02)
    torch.testing.assert_close(got, c2c.c2c_matmul_plain(x, w, 0.02),
                               rtol=1e-4, atol=1e-3)
    spikes = (x > 0.5).to(torch.float32)
    assert torch.equal(c2c.c2c_matmul_cuda(spikes, w, 0.02),
                       c2c.c2c_matmul_plain(spikes, w, 0.02))
    assert torch.equal(ops.c2c_matmul(spikes, w, 0.02),
                       c2c.c2c_matmul_plain(spikes, w, 0.02))


def test_cuda_c2c_matmul_int8_extremes_and_refusals(card):
    x = torch.ones(8, 128, device=card)
    w = torch.full((128, 128), -128, dtype=torch.int8, device=card)
    assert torch.equal(c2c.c2c_matmul_cuda(x, w, 1.0),
                       torch.full((8, 128), -128.0 * 128, device=card))
    assert c2c.c2c_matmul_cuda(x[:0], w, 1.0).shape == (0, 128)
    assert torch.equal(c2c.c2c_matmul_cuda(x[:, :0], w[:0], 1.0),
                       torch.zeros(8, 128, device=card))
    with pytest.raises(ValueError, match="int8"):
        c2c.c2c_matmul_cuda(x, w.float(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        c2c.c2c_matmul_cuda(x.t(), w, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        c2c.c2c_matmul_cuda(x, w.cpu(), 1.0)


def test_cuda_stream_server_matches_cpu_path(card):
    """The always-on server on the card serves every request bit-exactly as
    on the CPU path, dispatches the same buckets, and keeps at most one
    input buffer per bucket."""
    rng = np.random.default_rng(11)
    sizes = (96, 64, 10)
    spec = AcceleratorSpec("small", n_cores=2, n_engines=8, n_caps=16,
                           weight_mem_bytes=64 * 1024)
    mapped = map_model(_pruned_mlp(rng, sizes), spec)
    trace = synth_arrival_trace(24, sizes[0], mode="bursty", t_lo=3,
                                t_hi=12, seed=4)
    policy = BucketPolicy(batch_sizes=(2, 4), time_steps=(8, 16))
    served = {}
    for device in ("cpu", card):
        model = mapped.pack(device=device)
        server = StreamServer(model, policy=policy, clock=VirtualClock(),
                              service_model=lambda b, t: 0.002)
        _build.reset_launches()
        results, rids = serve_trace(server, trace)
        if device == card:
            assert server.donate
            assert _build.launches["event_synapse"] > 0
            assert 0 < len(model.input_buffers) <= policy.n_buckets
        served[str(device)] = (results, rids, server.metrics.snapshot(),
                               [(r["b_pad"], r["t_pad"], r["n_requests"])
                                for r in server.telemetry])
    (r_cpu, rid_cpu, m_cpu, d_cpu), (r_gpu, rid_gpu, m_gpu, d_gpu) = \
        served.values()
    assert rid_cpu == rid_gpu and d_cpu == d_gpu and m_cpu == m_gpu
    for rid in rid_cpu:
        np.testing.assert_array_equal(r_gpu[rid].out_spikes,
                                      r_cpu[rid].out_spikes)
