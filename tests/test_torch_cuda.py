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

from _torch_sweep import (batched_diffs, build_case, map_case, oracle_diffs,
                          sweep_cases)
from repro_torch.core.accelerator import map_model, run, run_batch
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


@pytest.mark.parametrize("n_rows,n_src,n_dest,max_ev", [
    (37, 16, 128, 16), (37, 700, 1000, 700), (37, 2048, 1024, 300),
    (37, 33, 7, 5), (37, 1500, 130, 1500),
    (300, 1200, 1000, 1200),     # more rows than one block takes
    (300, 513, 7, 100),          # and a truncated MEM_E depth
])
def test_cuda_event_synapse_matches_plain(card, n_rows, n_src, n_dest,
                                          max_ev):
    rng = np.random.default_rng(n_src)
    w = _t(rng.normal(size=(n_src, n_dest)).astype(np.float32)).to(card)
    spikes = _t((rng.random((n_rows, n_src)) < 0.3)
                .astype(np.float32)).to(card)
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


def _edge_spikes(pattern):
    """[rows, n_src] rasters whose event lists sit where the dense kernel's
    streaming can go wrong."""
    if pattern == "chunk_boundaries":
        # each row group of the kernel starts its chunks at its least first
        # event; events sit on both sides of every multiple of 128 from
        # there, and a row group with a gap makes the kernel skip chunks
        n_src = 4200
        sp = np.zeros((200, n_src), np.float32)
        for lo, rows in ((0, range(0, 4)), (3, range(64, 70)),
                         (1000, range(128, 133))):
            edges = np.arange(lo + 127, n_src, 128)
            for i, r in enumerate(rows):
                sp[r, lo] = 1
                sp[r, edges[i % 2::2]] = 1
                sp[r, np.minimum(edges[i % 2::2] + 1, n_src - 1)] = 1
        sp[130, 1500:3300] = 0          # the gap
        return sp
    if pattern == "one_full_row":
        sp = np.zeros((9, 5000), np.float32)
        sp[3] = 1                       # every source, beside silent rows
        sp[7, ::97] = 1
        return sp
    if pattern == "first_and_last_source":
        sp = np.zeros((70, 777), np.float32)
        sp[::3, 0] = 1
        sp[1::2, 776] = 1
        return sp
    raise ValueError(pattern)


ROUTES = ("dense", "packed2", "packed4", "packed8")


def _route_pair(route, rng, n_src, n_dest, device):
    """(kernel, plain) closures of one event_synapse route over a seeded
    tile: f32 normal weights, or random codes of the width packed with
    pack_signmag (n_dest cut to a whole number of codes a byte)."""
    if route == "dense":
        w = _t(rng.normal(size=(n_src, n_dest)).astype(np.float32)).to(device)
        return (lambda ev, **kw: es.event_synapse_cuda(ev, w, **kw),
                lambda ev: es.event_synapse_plain(ev, w))
    bits = int(route[len("packed"):])
    nd = max(n_dest - n_dest % (8 // bits), 8 // bits)
    pk = _t(pack_signmag(_codes(rng, n_src, nd, bits), bits)).to(device)
    return (lambda ev, **kw: es.event_synapse_packed_cuda(ev, pk, 0.013, bits,
                                                          **kw),
            lambda ev: es.event_synapse_packed_plain(ev, pk, 0.013, bits))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("pattern,n_dest", [
    ("chunk_boundaries", 130), ("chunk_boundaries", 1000),
    ("one_full_row", 200), ("first_and_last_source", 1000),
    ("first_and_last_source", 7),
])
def test_cuda_event_synapse_edge_lists(card, pattern, n_dest, route):
    """The streaming kernel, f32 and packed at every width, bit for bit on
    event lists that sit on chunk boundaries, skip chunks, fill a whole
    row, or touch source 0 and the last source."""
    sp = _edge_spikes(pattern)
    rng = np.random.default_rng(sp.shape[1])
    kernel, plain = _route_pair(route, rng, sp.shape[1], n_dest, card)
    ev = ops.events_from_spikes(_t(sp).to(card), sp.shape[1])
    assert torch.equal(kernel(ev), plain(ev))


def _gappy(ev: np.ndarray, rng) -> np.ndarray:
    """A compacted list ``[R, E]`` spread to ``[R, 2E]`` with a -1 after
    every entry and about a tenth of the entries masked to -1, so that
    every row with events has interior -1s; the valid entries still
    ascend."""
    wide = np.full((ev.shape[0], 2 * ev.shape[1]), -1, np.int32)
    wide[:, ::2] = ev
    wide[rng.random(wide.shape) < 0.1] = -1
    return wide


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n_src,n_dest", [(700, 130), (4200, 1000),
                                          (777, 7)])
def test_cuda_event_synapse_interior_padding(card, route, n_src, n_dest):
    """Lists with interior -1s and all -1 rows, through the public ops
    (compacted on the card, then the kernel): bit for bit the plain
    version, which adds every valid entry in list order, and the kernel on
    the compacted list; a scale handed as a CUDA tensor reads the same."""
    rng = np.random.default_rng(n_src + n_dest)
    sp = (rng.random((70, n_src)) < 0.2).astype(np.float32)
    sp[[0, 33]] = 0
    ev = ops.events_from_spikes(_t(sp).to(card), n_src).cpu().numpy()
    wide = _t(_gappy(ev, rng)).to(card)
    kernel, plain = _route_pair(route, rng, n_src, n_dest, card)
    got = kernel(wide)
    assert torch.equal(got, plain(wide))
    assert torch.equal(got, kernel(es.compact_events(wide), compacted=True))
    if route != "dense":
        bits = int(route[len("packed"):])
        nd = max(n_dest - n_dest % (8 // bits), 8 // bits)
        pk = _t(pack_signmag(_codes(rng, n_src, nd, bits), bits)).to(card)
        on_card = torch.tensor([[0.013]], device=card)
        assert torch.equal(
            ops.event_synapse_packed(wide, pk, on_card, bits=bits),
            ops.event_synapse_packed(wide, pk, np.float32(0.013), bits=bits))


@pytest.mark.parametrize("route", ROUTES)
def test_cuda_event_synapse_rejects_unsorted_rows(card, route):
    """A row whose valid entries do not ascend strictly (unsorted, or a
    repeat), or that holds a source past the tile, raises ValueError: the
    kernel adds in ascending source chunks and cannot keep such a row's
    list order."""
    kernel, _ = _route_pair(route, np.random.default_rng(2), 64, 32, card)
    for bad in ([[1, 5, -1], [7, 3, -1]], [[2, 2, -1]], [[4, -1, 0]]):
        with pytest.raises(ValueError, match="ascending"):
            kernel(torch.tensor(bad, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="n_src"):
        kernel(torch.tensor([[3, 64]], dtype=torch.int32, device=card))


def _random_model(sizes, bits, device, packed_ops, seed):
    """A PackedModel of the layer sizes made straight from seeded
    ``bits``-bit codes, without map_model: each layer's tile is
    ``fl32(q * scale)``, f32 (``packed_ops=False``) or packed codes with the
    scale on the card and on the host, padded as pack_model pads."""
    rng = np.random.default_rng(seed)
    layers = []
    qmax = 2 ** (bits - 1) - 1
    for a, b in zip(sizes[:-1], sizes[1:]):
        n_pad = br._pad_dest(b, br.DEFAULT_BLOCK_D)
        n_pad = -(-n_pad // (8 // bits)) * (8 // bits)
        q = np.zeros((a, n_pad), np.int8)
        q[:, :b] = rng.integers(-qmax, qmax + 1, (a, b))
        scale = np.float32(3.0 / (qmax * np.sqrt(a)))
        layer = br.PackedLayer(rounds=[], n_src=a, n_dest=b, n_dest_pad=n_pad,
                               bits=bits)
        if packed_ops:
            layer.w_packed = _t(pack_signmag(q, bits)).to(device)
            layer.scale = torch.tensor([[scale]], device=device)
            layer.scale_host = scale
        else:
            layer.w_fused = _t(q.astype(np.float32) * scale).to(device)
        layers.append(layer)
    return br.PackedModel(layers=layers, lif=LIFParams(beta=0.9,
                                                       threshold=1.0),
                          device=torch.device(device))


@pytest.mark.parametrize("sizes,bits", [
    ((32768, 1000, 500, 200, 100, 10), 8),   # CIFAR10-DVS, native width
    ((2312, 200, 100, 40, 10), 4),           # N-MNIST at 4 bits
])
def test_cuda_forward_is_sync_free(card, sizes, bits):
    """The engine's forward, dense and packed, reads nothing from the
    card: it runs under ``set_sync_debug_mode("error")``, which raises on
    any operation that waits for the device, and both routes give the same
    spikes."""
    rng = np.random.default_rng(bits)
    x = _t((rng.random((8, 16, sizes[0])) < 0.1).astype(np.float32)).to(card)
    models = [_random_model(sizes, bits, card, p, seed=bits)
              for p in (False, True)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [br._forward_impl(m, x, None) for m in models]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("route", ROUTES)
def test_cuda_event_synapse_input_layer_rate_maps(card, route):
    """The CIFAR10-DVS input layer at its real shape: events [128, 32768]
    from the class rate maps (8 requests of 16 steps) into a seeded
    [32768, 1024] tile, f32 or packed codes, bit for bit."""
    from repro_torch.configs.menage_paper import CIFAR_DATA
    from repro_torch.data.events import _class_rate_maps
    rng = np.random.default_rng(0)
    maps = _class_rate_maps(CIFAR_DATA).reshape(CIFAR_DATA.num_classes, -1)
    sp = (rng.random((8, 16, CIFAR_DATA.n_in), dtype=np.float32)
          < maps[np.arange(8) % CIFAR_DATA.num_classes, None]).astype(
              np.float32)
    spikes = _t(sp.reshape(128, -1)).to(card)
    kernel, plain = _route_pair(route, rng, CIFAR_DATA.n_in, 1024, card)
    ev = ops.events_from_spikes(spikes, CIFAR_DATA.n_in)
    assert ev.shape == (128, 32768)
    assert torch.equal(kernel(ev), plain(ev))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("scale", [0.013, -0.37])
def test_cuda_event_synapse_packed_every_code(card, bits, scale):
    """Every sign-magnitude word of the width, the code "-0" (sign bit set,
    magnitude 0) included, in every column position of a byte, dequantised
    and summed bit for bit as the plain version does, at a positive and a
    negative scale (where 0 * scale is -0.0)."""
    n_words = 2 ** bits
    ell = 8 // bits
    n_dest = 64 * ell                    # whole 16-byte rows
    # row s holds word (s + j) % n_words in column j
    words = ((np.arange(n_words)[:, None] + np.arange(n_dest)[None])
             % n_words).astype(np.uint8)
    packed = np.zeros((n_words, n_dest // ell), np.uint8)
    for lane in range(ell):
        packed |= words[:, lane::ell] << (lane * bits)
    pk = _t(packed.view(np.int8)).to(card)
    spikes = torch.zeros(3 * n_words, n_words, device=card)
    for s in range(n_words):
        spikes[s, s] = 1                 # each code alone
        spikes[n_words + s, :s + 1] = 1  # running sums
    spikes[2 * n_words:, ::2] = 1
    ev = ops.events_from_spikes(spikes, n_words)
    got = es.event_synapse_packed_cuda(ev, pk, scale, bits)
    want = es.event_synapse_packed_plain(ev, pk, scale, bits)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got[:n_words]),
                       torch.signbit(want[:n_words]))


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


LIF_SHAPES = [
    (8, 16, 1024), (8, 32, 1024), (8, 16, 512), (8, 16, 200),
    (8, 16, 100), (8, 16, 10),           # the engine's layers and buckets
    (8, 16, 301), (5, 33, 301), (2, 100, 10),   # rows not 16-byte multiples
    (3, 1, 1024), (4, 33, 1024), (4, 100, 1024), (2, 100, 200),  # T chunks
    (32, 25, 1024), (1, 7, 1), (130, 3, 64),
]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", LIF_SHAPES)
def test_cuda_lif_scan_matches_plain_at_shapes(card, shape, offset):
    """The redesigned LIF kernel, bit for bit the plain version at the
    engine's shapes, at rows TMA cannot take (n = 10, 301), at T = 1 and T
    past one 32-step chunk (33, 100), and (offset 1) from a base that is
    not 16-byte aligned, which takes the plain-row kernel at every n."""
    rng = np.random.default_rng(sum(shape))
    n = int(np.prod(shape))
    buf = torch.empty(n + offset, device=card)
    cur = buf[offset:].view(shape)
    cur.copy_(_t(rng.normal(0.35, 0.6, shape).astype(np.float32)))
    p = LIFParams(beta=0.85, threshold=0.7, v_reset=0.1)
    got = lu.lif_scan_cuda(cur, p)
    assert torch.equal(got, lu.lif_scan_plain(cur, p))
    if got.numel() >= 100:
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("b,n", [(8, 1024), (8, 512), (8, 200), (8, 10),
                                 (5, 301), (1, 1), (40, 512)])
def test_cuda_lif_update_single_step_matches_plain(card, b, n):
    """The single clock edge (T = 1, v0 read, v_out written): v' and the
    spikes bit for bit the plain version's."""
    rng = np.random.default_rng(b * n)
    v = _t(rng.normal(0.5, 0.6, (b, n)).astype(np.float32)).to(card)
    i = _t(rng.normal(0.3, 0.6, (b, n)).astype(np.float32)).to(card)
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


@pytest.mark.parametrize("idx", range(64))
def test_cuda_equivalence_sweep_on_both_routes(card, idx):
    """The oracle-equivalence sweep's case ``idx`` (``tests/_torch_sweep.py``:
    conv COO tiles with stride and padding, compressed dictionaries fused
    into one tile, MEM_E caps down to 0, 2/4/8-bit mixtures) on both CUDA
    routes, bit for bit against the CPU path and the numpy oracle."""
    case = sweep_cases()[idx]
    layers, spikes = build_case(case)
    model = map_case(case, layers)
    cap = case["max_events"]
    oracle = run_batch(model, spikes, max_events=cap)
    for packed_ops in (False, True):
        got = br.run_batched(model.pack(device=card, packed_ops=packed_ops),
                             spikes, max_events=cap)
        cpu = br.run_batched(model.pack(device="cpu", packed_ops=packed_ops),
                             spikes, max_events=cap)
        assert batched_diffs(got, cpu) == [], packed_ops
        assert oracle_diffs(got, oracle) == [], packed_ops


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (65, 33, 70), (130, 1500, 257), (256, 1024, 1024),
    (7, 9000, 129),
    (129, 4097, 1025),           # every 128 x 128 tile and 32-step K ragged
    (128, 32768, 1024),          # the CIFAR10-DVS input layer as a MAC
])
def test_cuda_c2c_matmul_matches_plain(card, m, k, n):
    """The kernel against ``(x @ w_q) * scale`` at ragged shapes (edges
    guarded, K split or not), every code -128..127 drawn, at the
    reference's tolerance and within the summation bound
    ``2 (K + 1) 2**-24 (|x| @ |w_q|) |scale|``, the same result from two
    calls; with 0/1 inputs and integer codes every partial sum is an
    integer below 2**24, so there the two agree bit for bit."""
    rng = np.random.default_rng(m * 7 + n)
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(card)
    w = _t(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(card)
    got = c2c.c2c_matmul_cuda(x, w, 0.02)
    plain = c2c.c2c_matmul_plain(x, w, 0.02)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-3)
    tol = 2 * (k + 1) * 2.0 ** -24 * (x.abs() @ w.float().abs()) * 0.02
    assert bool(((got - plain).abs() <= tol).all())
    assert torch.equal(c2c.c2c_matmul_cuda(x, w, 0.02), got)
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


def test_cuda_socket_round_trip_matches_cpu_path(card):
    """The live-socket server on the card: a small MLP on the dense route,
    hot-swapped over ADMIN to its packed route, serves every request
    through the kernels, each result equal to the CPU path's."""
    from repro_torch.engine import ModelRegistry
    from repro_torch.launch.socket_serve import (SpikeClient,
                                                 SpikeSocketServer,
                                                 serving_thread)
    rng = np.random.default_rng(12)
    sizes = (96, 64, 10)
    spec = AcceleratorSpec("small", n_cores=2, n_engines=8, n_caps=16,
                           weight_mem_bytes=64 * 1024)
    mapped = map_model(_pruned_mlp(rng, sizes), spec)
    policy = BucketPolicy(batch_sizes=(2, 4), time_steps=(8, 16))
    streams = [(rng.random((int(t), sizes[0])) < 0.3).astype(np.float32)
               for t in rng.integers(3, 16, 12)]
    want = run_bucketed(mapped.pack(device="cpu"), streams, policy=policy,
                        with_stats=False)
    registry = ModelRegistry(device=card)
    registry.register("m", mapped.pack(device=card), policy=policy)
    packed = mapped.pack(packed_ops=True, device=card)
    srv = SpikeSocketServer(registry, model_factory=lambda spec: packed)
    host, port = srv.address
    _build.reset_launches()
    with serving_thread(srv, max_requests=len(streams), idle_flush_s=0.05):
        cli = SpikeClient(host, port, timeout=30)
        ids = [cli.send(s, model="m") for s in streams[:8]]
        swap = cli.admin({"op": "swap", "model": "m"})
        ids += [cli.send(s, model="m") for s in streams[8:]]
        cli.recv_all()
        cli.close()
    torch.cuda.synchronize()
    assert cli.admin_replies[swap]["generation"] == 2
    assert all(_build.launches[k] > 0 for k in
               ("event_synapse", "event_synapse_packed", "lif_update"))
    for req_id, r in zip(ids, want):
        np.testing.assert_array_equal(cli.results[req_id], r.out_spikes)


# ------------------------------------- the rest of the core on the card


@pytest.mark.parametrize("bits", [(8, 4, 2, 4), (2, 8, 4, 8), (4, 4, 2, 2)])
def test_cuda_mixed_width_forward_bit_exact_and_sync_free(card, bits):
    """A model mapped at per-layer widths (what search_bits returns),
    packed with ``packed_ops=True``: one forward launches the packed
    kernel at each layer's own width, runs under
    ``set_sync_debug_mode("error")``, and equals the CPU path and the
    oracle bit for bit (spikes, dispatch stats, energy)."""
    sizes = (2312, 200, 100, 40, 10)
    rng = np.random.default_rng(sum(bits))
    ws = _pruned_mlp(rng, sizes, gain=2.5)
    spec = AcceleratorSpec("mixed", n_cores=4, n_engines=10, n_caps=16,
                           weight_mem_bytes=400 << 10)
    m = map_model(ws, spec, quant_bits=list(bits))
    gpu = m.pack(packed_ops=True, device=card)
    x = (rng.random((2, 12, sizes[0])) < 0.08).astype(np.float32)
    xt = _t(x).to(card)
    br._forward_impl(gpu, xt, None)                    # first call warms
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = br._forward_impl(gpu, xt, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = {b: bits.count(b) for b in (8, 4, 2)}
    assert _build.packed_launches_by_bits == want
    cpu = br._forward_impl(m.pack(packed_ops=True, device="cpu"),
                           _t(x), None)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(outs, cpu))
    res = br.run_batched(gpu, x)
    assert res.per_layer_bits == list(bits)
    for i in range(2):
        oracle = run(m, x[i])
        np.testing.assert_array_equal(res.out_spikes[i], oracle.out_spikes)
        assert res.sample_energy(i) == oracle.energy


GRAPH_SIZES = (300, 200, 100, 40, 10)
GRAPH_ROUTES = [(False, 8), (True, 4)]          # dense f32 tile, packed 4-bit


def _counts():
    return dict(_build.launches), dict(_build.packed_launches_by_bits)


def _replayed(model, x, max_events):
    """Every layer's output of one engine call on ``x`` through the donated
    buffer and the shape's graph, copied off the card."""
    spikes = br._upload(model, x, True)
    return [o.clone() for o in br._replay(model, spikes, max_events)]


@pytest.mark.parametrize("packed_ops,bits", GRAPH_ROUTES)
def test_cuda_replayed_forward_equals_eager_at_every_shape(card, packed_ops,
                                                           bits):
    """Every shape of the default bucket grid, with a full and a finite
    MEM_E depth: a replay of the shape's graph equals an eager forward
    layer by layer, a second call with other spikes answers them (the
    static input is refilled, nothing recaptured), and each replay counts
    the launches the eager forward makes."""
    model = _random_model(GRAPH_SIZES, bits, card, packed_ops, seed=bits)
    rng = np.random.default_rng(30 + bits)
    pol = BucketPolicy()
    for max_events in (None, 24):
        for b in pol.batch_sizes:
            for t in pol.time_steps:
                entry = None
                for _ in range(2):
                    x = (rng.random((b, t, GRAPH_SIZES[0]))
                         < 0.1).astype(np.float32)
                    _build.reset_launches()
                    want = br._forward_impl(model, _t(x).to(card), max_events)
                    eager = _counts()
                    for _ in range(2):      # a shape's first call captures
                        _build.reset_launches()
                        got = _replayed(model, x, max_events)
                        assert _counts() == eager
                        assert [torch.equal(g, w) for g, w in
                                zip(got, want)] == [True] * len(want), \
                            (b, t, max_events)
                    key = (b, t, max_events)
                    assert entry is None or model.graphs[key] is entry
                    entry = model.graphs[key]
                res = br.run_batched(model, x, max_events=max_events,
                                     with_stats=False)
                np.testing.assert_array_equal(res.out_spikes,
                                              want[-1].cpu().numpy())
    assert len(model.graphs) == 2 * pol.n_buckets


@pytest.mark.parametrize("packed_ops,bits", GRAPH_ROUTES)
def test_cuda_run_batched_replays_under_its_span(card, packed_ops, bits):
    """run_batched on a card replays: under a profiler each engine call
    closes one ``engine.replay`` inside its ``engine.forward``, the launch
    counters advance per call as an eager forward's do, and the answers
    equal the CPU path's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.tracing import stage_totals
    model = _random_model(GRAPH_SIZES, bits, card, packed_ops, seed=5)
    cpu = _random_model(GRAPH_SIZES, bits, "cpu", packed_ops, seed=5)
    rng = np.random.default_rng(5)
    xs = [(rng.random((4, 16, GRAPH_SIZES[0])) < 0.1).astype(np.float32)
          for _ in range(3)]
    br.run_batched(model, xs[0], with_stats=False)
    _build.reset_launches()
    br._forward_impl(model, _t(xs[0]).to(card), None)
    eager = _counts()
    before, got = stage_totals(), []
    with profile(activities=[ProfilerActivity.CPU]):
        for x in xs:
            _build.reset_launches()
            got.append(br.run_batched(model, x, with_stats=False).out_spikes)
            assert _counts() == eager
    after = stage_totals()
    for x, out in zip(xs, got):
        np.testing.assert_array_equal(out, br.run_batched(cpu, x).out_spikes)
    for name in ("engine.forward", "engine.replay"):
        assert after[name][1] - before.get(name, (0.0, 0))[1] == len(xs)
    assert list(model.graphs) == [(4, 16, None)]


def test_cuda_twin_and_swapped_tiles_answer_with_their_own_weights(card):
    """A ``dataclasses.replace`` d model (the noise twin) starts with no
    graph and answers with its own weights; a model whose tile is swapped
    recaptures instead of replaying the old one."""
    from repro_torch.core.noise import AnalogNoise, perturb_packed
    model = _random_model(GRAPH_SIZES, 8, card, False, seed=6)
    rng = np.random.default_rng(6)
    x = (rng.random((4, 8, GRAPH_SIZES[0])) < 0.2).astype(np.float32)
    base = _replayed(model, x, None)
    twin = perturb_packed(3, model, AnalogNoise(weight_sigma=0.3))
    assert twin.graphs == {} and twin.input_buffers == {}
    got = _replayed(twin, x, None)
    want = br._forward_impl(twin, _t(x).to(card), None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not all(torch.equal(g, w) for g, w in zip(got, base))
    assert all(torch.equal(g, w)
               for g, w in zip(_replayed(model, x, None), base))
    old = model.graphs[(4, 8, None)]
    model.layers[0].w_fused = twin.layers[0].w_fused.clone()
    got = _replayed(model, x, None)
    assert model.graphs[(4, 8, None)] is not old
    want = br._forward_impl(model, _t(x).to(card), None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cuda_donate_off_never_replays(card):
    """Without a donated buffer there is no static input: run_batched
    issues the forward and captures nothing."""
    model = _random_model(GRAPH_SIZES, 4, card, True, seed=7)
    cpu = _random_model(GRAPH_SIZES, 4, "cpu", True, seed=7)
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = (rng.random((4, 8, GRAPH_SIZES[0])) < 0.1).astype(np.float32)
        res = br.run_batched(model, x, donate=False)
        np.testing.assert_array_equal(res.out_spikes,
                                      br.run_batched(cpu, x).out_spikes)
    assert model.graphs == {} and model.input_buffers == {}


# (B, T) buckets in the order a serving loop might meet them: each shape
# comes back after others have run, some with shorter requests than before
STAGING_SHAPES = [(4, 8), (16, 16), (4, 8), (1, 32), (16, 16), (4, 8),
                  (1, 32)]


@pytest.mark.parametrize("packed_ops,bits", GRAPH_ROUTES)
def test_cuda_pinned_mask_staging_equals_the_eager_float_path(card,
                                                              packed_ops,
                                                              bits):
    """execute_plan over a rotating sequence of buckets: each call stages
    its requests as a uint8 mask in the shape's pinned buffer and replays
    the shape's graph on the uint8 donated buffer, and equals bit for bit
    the eager forward of the zero-padded float32 raster and its record.
    Both buffers stay put across calls of their shape."""
    from repro_torch.engine import serving
    model = _random_model(GRAPH_SIZES, bits, card, packed_ops, seed=11)
    rng = np.random.default_rng(11 + bits)
    values = np.array([-1.5, -0.25, 0, 0, 0, 0, 0, 0, 0, 0.125, 1.0, 2.5],
                      np.float32)
    ptrs = {}
    for seq, (b, t) in enumerate(STAGING_SHAPES):
        lengths = rng.integers(1, t + 1, size=int(rng.integers(1, b + 1)))
        streams = [rng.choice(values, size=(int(n), GRAPH_SIZES[0]))
                   for n in lengths]
        plan = serving.BatchPlan(indices=tuple(range(len(streams))),
                                 b_pad=b, t_pad=t)
        got, record = serving.execute_plan(model, streams, plan, seq=seq)
        padded = np.zeros((b, t, GRAPH_SIZES[0]), np.float32)
        for row, x in enumerate(streams):
            padded[row, :len(x)] = x
        outs = br._forward_impl(model, _t(padded).to(card), None)
        want = br._finalize(model, padded, [o.cpu().numpy() for o in outs],
                            None, None, True)
        for row, x in enumerate(streams):
            np.testing.assert_array_equal(got[row].out_spikes,
                                          want.out_spikes[row, :len(x)])
            for a, w in zip(got[row].stats, want.sample_stats(row)):
                np.testing.assert_array_equal(a.events, w.events[:len(x)])
        assert record["events"] == sum(int((x > 0).sum()) for x in streams)
        assert record["out_spikes"] == sum(
            int(want.out_spikes[row, :len(x)].sum())
            for row, x in enumerate(streams))
        staged = model.staging[(b, t)].mask
        buf = model.input_buffers[(b, t)]
        assert _t(staged).is_pinned() and staged.dtype == np.uint8
        assert buf.dtype == torch.uint8 and buf.device == model.device
        assert torch.equal(buf.cpu(), _t(padded > 0).to(torch.uint8))
        pair = (staged.ctypes.data, buf.data_ptr())
        assert ptrs.setdefault((b, t), pair) == pair
    shapes = sorted(set(STAGING_SHAPES))
    assert sorted(model.input_buffers) == shapes
    assert sorted(model.graphs) == [(b, t, None) for b, t in shapes]


def test_cuda_capture_outlives_a_collected_staging_buffer(card, monkeypatch):
    """A model whose pinned staging buffer carried a copy, left as cyclic
    garbage, is not collected inside another model's capture: freeing the
    buffer there would record an event on its copy's stream and end the
    capture.  The capture here meets a collection's trigger mid-way."""
    import gc

    from repro_torch.engine import serving
    rng = np.random.default_rng(12)
    streams = [(rng.random((8, GRAPH_SIZES[0])) < 0.1).astype(np.float32)]
    plan = serving.BatchPlan(indices=(0,), b_pad=1, t_pad=8)
    old = _random_model(GRAPH_SIZES, 8, card, False, seed=12)
    serving.execute_plan(old, streams, plan)
    assert _t(old.staging[(1, 8)].mask).is_pinned()
    old.replicas["cycle"] = old
    garbage = [old]
    del old
    forward = br._forward_impl

    def forward_meeting_the_collector(packed, spikes, max_events):
        if torch.cuda.is_current_stream_capturing() and garbage:
            garbage.clear()                 # only its own cycle holds it
            thresholds = gc.get_threshold()
            gc.set_threshold(1)
            try:
                _ = [[] for _ in range(1000)]
            finally:
                gc.set_threshold(*thresholds)
        return forward(packed, spikes, max_events)

    monkeypatch.setattr(br, "_forward_impl", forward_meeting_the_collector)
    model = _random_model(GRAPH_SIZES, 8, card, False, seed=13)
    first, _ = serving.execute_plan(model, streams, plan)   # eager, capture
    assert not garbage and (1, 8, None) in model.graphs
    gc.collect()
    again, _ = serving.execute_plan(model, streams, plan)   # replay
    np.testing.assert_array_equal(first[0].out_spikes, again[0].out_spikes)


@pytest.mark.parametrize("n_in,n_out,t,b,p", [
    (4096, 512, 16, 8, 0.05),     # lists 4096 wide, about 200 valid
    (8192, 256, 8, 16, 0.01),     # 8192 wide, about 80 valid
    (1000, 130, 5, 3, 0.3),
])
def test_cuda_spikified_linear_equals_plain(card, n_in, n_out, t, b, p):
    """``spikified_linear`` on the card (one dense kernel launch over all
    ``T * B`` rows, event lists far longer than their valid prefix) equals
    the same arithmetic on the plain version for the same frames (the
    generator reseeded), and the CPU path on those frames, bit for bit."""
    from repro_torch.core.lif import rate_encode
    from repro_torch.core.spikify import (accumulate_frames, rate_scale,
                                          spikified_linear)
    rng = np.random.default_rng(n_in)
    x = np.abs(rng.normal(size=(b, n_in))).astype(np.float32)
    x[rng.random(x.shape) > p * 4] = 0
    xt = _t(x).to(card)
    w = _t(rng.normal(size=(n_in, n_out)).astype(np.float32)).to(card)
    gen = torch.Generator(device=card)
    _build.reset_launches()
    y, st = spikified_linear(gen.manual_seed(5), xt, w, num_steps=t)
    torch.cuda.synchronize()
    assert _build.launches["event_synapse"] == 1
    rates, x_max = rate_scale(xt)
    frames = rate_encode(rates, t, gen.manual_seed(5))
    ev = ops.events_from_spikes(frames.reshape(t * b, n_in), n_in)
    cur = es.event_synapse_plain(ev, w).reshape(t, b, n_out)
    acc = torch.zeros(b, n_out, device=card)
    for step in range(t):
        acc = acc + cur[step]
    steps = torch.tensor(float(t), device=card)
    assert torch.equal(y, acc / steps * x_max)
    assert int(st["events"]) == int((ev >= 0).sum())
    valid = (ev >= 0).sum(dim=1)
    assert int(valid.max()) < n_in // 2           # mostly padding
    acc_cpu, n_cpu = accumulate_frames(frames.cpu(), w.cpu())
    assert torch.equal(acc.cpu(), acc_cpu) and int(n_cpu) == int(st["events"])


# ------------------------------------------------------------- training

def _train_setup(family):
    from repro_torch.data.events import (EventDatasetConfig,
                                         synthetic_event_dataset)
    from repro_torch.engine import CONV_MODEL, MLP_MODEL
    from repro_torch.snn import ConvSNNConfig, SNNConfig
    data = EventDatasetConfig("card-train", 8, 8, num_steps=8,
                              base_rate=0.02, signal_rate=0.5)
    spikes, labels = synthetic_event_dataset(data, 4,
                                             np.random.default_rng(0))
    if family == "mlp":
        return MLP_MODEL, SNNConfig((data.n_in, 24, 10), num_steps=8), \
            spikes, labels
    return CONV_MODEL, ConvSNNConfig((2, 8, 8), (4, 8), num_steps=8), \
        spikes, labels


def _train_batch(spikes, labels, device, step=0, lr=2e-3):
    from repro_torch.data.events import event_batch_at
    sp, lb = event_batch_at(spikes, labels, 16, step)
    return {"spikes": _t(np.ascontiguousarray(sp)).to(device),
            "labels": _t(lb).to(device),
            "lr": torch.full((), lr, dtype=torch.float32, device=device)}


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_cuda_train_step_matches_cpu_and_is_sync_free(card, family):
    """One ``make_snn_train_step`` call on the card from the CPU's start on
    the same batch: it reads nothing from the device (it runs under
    ``set_sync_debug_mode("error")``), its loss is the CPU's within rtol
    1e-4, its accuracy equal, and its parameters within two lr (Adam's
    first step moves a weight by up to lr whatever the size of its
    gradient, so a near-zero gradient whose float32 sum has the other sign
    on the CPU moves the two apart by up to 2 lr)."""
    from repro_torch.engine import make_snn_train_step
    from repro_torch.engine.train_loop import init_train_state
    from repro_torch.engine.snn_train import SNNTrainConfig
    model, cfg, spikes, labels = _train_setup(family)
    opt_cfg = SNNTrainConfig().adamw()
    params = model.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    step = make_snn_train_step(model, cfg, opt_cfg, grad_shards=2)
    want, wm = step(init_train_state(None, params, opt_cfg).as_tree(),
                    _train_batch(spikes, labels, "cpu"))
    state = init_train_state(None, [p.to(card) for p in params],
                             opt_cfg).as_tree()
    batch = _train_batch(spikes, labels, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, gm = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-4)
    assert float(gm["acc"]) == float(wm["acc"])
    for a, b in zip(got["params"], want["params"]):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=4e-3)


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_cuda_resume_is_bit_exact(card, tmp_path, family):
    """On the card, stop at step 6 and resume to 12: the parameters equal
    an uninterrupted 12-step run's bit for bit (deterministic cuDNN and
    cuBLAS, TF32 off)."""
    from repro_torch.data.events import event_batch_at
    from repro_torch.engine import SNNTrainConfig, train_snn_model
    model, cfg, spikes, labels = _train_setup(family)

    def run(steps, ckpt):
        tc = SNNTrainConfig(steps=steps, lr=2e-3, grad_shards=2,
                            checkpoint_dir=ckpt, checkpoint_every=6,
                            log_every=1000)
        return train_snn_model(
            model, cfg, lambda s: event_batch_at(spikes, labels, 16, s), tc,
            key=torch.Generator().manual_seed(1), log_fn=lambda s: None)

    ref, ref_hist = run(12, str(tmp_path / "ref"))
    run(6, str(tmp_path / "ab"))
    resumed, hist = run(12, str(tmp_path / "ab"))
    assert hist["loss"] == ref_hist["loss"][6:]
    assert all(p.device.type == "cuda" for p in resumed)
    for a, b in zip(resumed, ref):
        assert torch.equal(a, b)


def test_cuda_trained_conv_served_on_dense_kernel(card):
    """A conv SNN trained on the card, pruned and lowered with
    ``layer_specs``, served by ``run_bucketed`` on the dense event kernel:
    every clip equals the numpy oracle (spikes, cycles, engine ops)."""
    from repro_torch.core.prune import prune_pytree
    from repro_torch.data.events import event_batch_at
    from repro_torch.engine import CONV_MODEL, SNNTrainConfig, \
        train_snn_model
    from repro_torch.snn import layer_specs
    _, cfg, spikes, labels = _train_setup("conv")
    params, hist = train_snn_model(
        CONV_MODEL, cfg, lambda s: event_batch_at(spikes, labels, 16, s),
        SNNTrainConfig(steps=6, grad_shards=2),
        key=torch.Generator().manual_seed(1), log_fn=lambda s: None)
    assert np.isfinite(hist["loss"]).all()
    pruned, _ = prune_pytree(params, 0.5)
    spec = AcceleratorSpec("test", n_cores=8, n_engines=4, n_caps=8,
                           weight_mem_bytes=1 << 16)
    mapped = map_model(layer_specs(pruned, cfg), spec, lif=cfg.lif)
    assert any(len(layer.rounds) > 1 for layer in mapped.layers)
    clips = [spikes[i] for i in range(4)]
    _build.reset_launches()
    res = run_bucketed(mapped.pack(device=card), clips)
    assert _build.launches["event_synapse"] > 0
    for r, s in zip(res, clips):
        oracle = run(mapped, s)
        np.testing.assert_array_equal(r.out_spikes, oracle.out_spikes)
        for a, b in zip(r.stats, oracle.per_layer_stats):
            np.testing.assert_array_equal(a.cycles, b.cycles)
            np.testing.assert_array_equal(a.engine_ops, b.engine_ops)


# ---------------------------------------------------------------- the mesh

@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: a launch on a second card, with "
                    "another one current, shows only there")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _mesh_model(card, quant_bits, seed=5):
    rng = np.random.default_rng(seed)
    sizes = (300, 200, 64, 10)
    spec = AcceleratorSpec("mesh", n_cores=len(sizes) - 1, n_engines=8,
                           n_caps=16, weight_mem_bytes=1 << 18)
    mapped = map_model(_pruned_mlp(rng, sizes), spec, quant_bits=quant_bits)
    spikes = (rng.random((8, 12, sizes[0])) < 0.2).astype(np.float32)
    return mapped, spikes


def _same(a, b):
    np.testing.assert_array_equal(a.out_spikes, b.out_spikes)
    for x, y in zip(a.per_layer_stats, b.per_layer_stats):
        for f in ("cycles", "rows_touched", "engine_ops", "events",
                  "sn_bytes_touched", "mem_e_peak"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for x, y in zip(a.per_layer_util, b.per_layer_util):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.overflow, b.overflow):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("quant_bits", [8, 4])
def test_cuda_spoofed_mesh_bit_exact_on_both_routes(card, quant_bits):
    """A spoofed 2-way mesh on the card (two shards of one device, each
    with its own input buffer): run_sharded equals run_batched on the card
    and the CPU path on the dense and the packed route, each shard
    launching every layer's kernels."""
    from repro_torch.engine import run_sharded, snn_serve_mesh
    mapped, spikes = _mesh_model(card, quant_bits)
    want = br.run_batched(mapped.pack(device="cpu"), spikes)
    mesh = snn_serve_mesh(device=card, spoof=2)
    for packed_ops in (False, True):
        model = mapped.pack(packed_ops=packed_ops, device=card)
        _build.reset_launches()
        got = run_sharded(model, spikes, mesh=mesh)
        synapse = "event_synapse_packed" if packed_ops else "event_synapse"
        assert _build.launches[synapse] == 2 * len(mapped.layers)
        assert _build.launches["lif_update"] == 2 * len(mapped.layers)
        _same(got, want)
        _same(br.run_batched(model, spikes), want)
        assert sorted(k for k in model.input_buffers if len(k) == 3) == \
            [(0, 4, 12), (1, 4, 12)]


def test_cuda_sharded_forward_is_sync_free(card):
    """Every shard's forward, dense and packed, enqueued on its device
    under ``set_sync_debug_mode("error")``: nothing waits for the device
    before the results are copied back (on every card there is, or a
    spoofed 2-way mesh on one)."""
    from repro_torch.engine import snn_serve_mesh
    from repro_torch.engine.sharded_run import forward_shards
    n = torch.cuda.device_count()
    mesh = (snn_serve_mesh(2) if n >= 2
            else snn_serve_mesh(device=card, spoof=2))
    rng = np.random.default_rng(7)
    x = (rng.random((8, 16, 2312)) < 0.1).astype(np.float32)
    for packed_ops in (False, True):
        model = _random_model((2312, 200, 100, 40, 10), 8, card, packed_ops,
                              seed=8)
        shards = [_t(x[4 * s:4 * s + 4]).to(d)
                  for s, d in enumerate(mesh.devices)]
        for d in mesh.devices:
            model.replica(d)
            torch.cuda.synchronize(d)
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = forward_shards(model, shards, mesh.devices, None)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        whole = br._forward_impl(model, _t(x).to(card), None)
        got = torch.cat([o[-1].to(card) for o in outs])
        assert torch.equal(got, whole[-1])


@pytest.mark.parametrize("family", ["mlp", "conv"])
def test_cuda_mesh_training_bit_exact_with_one_device(card, family):
    """Training over a 2-way mesh (two cards where there are, else two
    shards of one) equals single-device training with ``grad_shards=2``
    bit for bit, losses and parameters, and its step reads nothing from
    the device."""
    from repro_torch.data.events import event_batch_at
    from repro_torch.engine import (SNNTrainConfig, make_snn_train_step,
                                    snn_train_mesh, train_snn_model)
    from repro_torch.engine.train_loop import init_train_state
    model, cfg, spikes, labels = _train_setup(family)
    mesh = (snn_train_mesh(2) if torch.cuda.device_count() >= 2
            else snn_train_mesh(device=card, spoof=2))
    data = lambda s: event_batch_at(spikes, labels, 16, s)  # noqa: E731
    runs = {}
    for tag, kw in (("mesh", dict(mesh=mesh)), ("one", dict(grad_shards=2))):
        runs[tag] = train_snn_model(
            model, cfg, data, SNNTrainConfig(steps=4, lr=2e-3,
                                             log_every=1000, **kw),
            key=torch.Generator().manual_seed(1), log_fn=lambda s: None)
    (pm, hm), (p1, h1) = runs["mesh"], runs["one"]
    assert hm["loss"] == h1["loss"]
    assert all(torch.equal(a, b) for a, b in zip(pm, p1))
    opt_cfg = SNNTrainConfig().adamw()
    step = make_snn_train_step(model, cfg, opt_cfg, mesh=mesh)
    state = init_train_state(None, [p.to(mesh.devices[0]) for p in pm],
                             opt_cfg).as_tree()
    batch = _train_batch(spikes, labels, mesh.devices[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_cuda_launchers_on_the_second_card(two_cards):
    """Every launcher given tensors on cuda:1 while cuda:0 is current
    launches there, on cuda:1's stream, and equals its plain version."""
    first, second = two_cards
    rng = np.random.default_rng(21)
    rows = np.full((40, 64), -1, np.int32)
    for r in range(40):
        k = rng.integers(0, 64)
        rows[r, :k] = np.sort(rng.choice(512, k, replace=False))
    events = _t(rows).to(second)
    w = _t(rng.normal(0, 1, (512, 300)).astype(np.float32)).to(second)
    codes = _codes(rng, 512, 300, 8)
    packed = _t(pack_signmag(codes, 8)).to(second)
    cur = _t(rng.normal(0.4, 0.7, (8, 20, 300)).astype(np.float32)).to(second)
    # 0/1 inputs and integer codes: every partial sum exact, so the
    # C2C kernel too equals its plain version bit for bit
    x = _t((rng.random((64, 256)) < 0.3).astype(np.float32)).to(second)
    wq = _t(codes[:256, :128].copy()).to(second)
    p = LIFParams(beta=0.85, threshold=0.7, v_reset=0.1)
    with torch.cuda.device(first):
        assert torch.cuda.current_device() == 0
        got = [es.event_synapse_cuda(events, w),
               es.event_synapse_packed_cuda(events, packed, 0.01, 8),
               lu.lif_scan_cuda(cur, p),
               *lu.lif_update_cuda(cur[:, 0].contiguous(),
                                   cur[:, 1].contiguous(), beta=0.85,
                                   threshold=0.7, v_reset=0.1),
               c2c.c2c_matmul_cuda(x, wq, 0.02)]
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(second)
    want = [es.event_synapse_plain(events, w),
            es.event_synapse_packed_plain(events, packed, 0.01, 8),
            lu.lif_scan_plain(cur, p),
            *lu.lif_update_plain(cur[:, 0], cur[:, 1], 0.85, 0.7, 0.1),
            c2c.c2c_matmul_plain(x, wq, 0.02)]
    for g, wt in zip(got, want):
        assert g.device == second and torch.equal(g, wt)
    with pytest.raises(ValueError, match="weights on"):
        es.event_synapse_cuda(events, w.to(first))
    with pytest.raises(ValueError, match="one device"):
        lu.lif_update_cuda(cur[:, 0].contiguous(),
                           cur[:, 1].contiguous().to(first), beta=0.85,
                           threshold=0.7, v_reset=0.1)


def test_cuda_lif_shared_memory_ceiling_on_each_card(two_cards):
    """lif_scan with 64 KiB of dynamic shared memory (T >= 32, 128-neuron
    tiles), above the 48 KiB a launch may take unasked: first on cuda:0,
    then on cuda:1, whose kernel attribute must be raised on its own."""
    p = LIFParams(beta=0.85, threshold=0.7, v_reset=0.1)
    rng = np.random.default_rng(22)
    host = _t(rng.normal(0.35, 0.6, (8, 64, 2048)).astype(np.float32))
    assert lu.tile_cols(8, 2048, 132) == 128
    for dev in two_cards:
        cur = host.to(dev)
        with torch.cuda.device(two_cards[0]):
            got = lu.lif_scan_cuda(cur, p)
        assert torch.equal(got, lu.lif_scan_plain(cur, p))


@pytest.mark.parametrize("quant_bits", [8, 4])
def test_cuda_real_mesh_equals_one_card(two_cards, quant_bits):
    """A real 2-way run_sharded over cuda:0 and cuda:1 (the model
    replicated once onto cuda:1) equals run_batched on cuda:0."""
    from repro_torch.engine import run_sharded, snn_serve_mesh
    mapped, spikes = _mesh_model(two_cards[0], quant_bits, seed=9)
    mesh = snn_serve_mesh(2)
    assert mesh.real and mesh.devices == two_cards
    for packed_ops in (False, True):
        model = mapped.pack(packed_ops=packed_ops, device=two_cards[0])
        _same(run_sharded(model, spikes, mesh=mesh),
              br.run_batched(model, spikes))
        rep = model.replicas[two_cards[1]]
        run_sharded(model, spikes, mesh=mesh)
        assert model.replicas[two_cards[1]] is rep


# ------------------------------------------------------------ the LM stack

LM_ATOL, LM_RTOL = 0.15, 0.05     # bf16 logits: the LM twins' tolerance


def _lm(arch, device):
    """A smoke LM's bundle and its seeded weights on the CPU and on
    ``device``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import build_model
    bundle = build_model(get_smoke_config(arch))
    params = bundle.init(seed=0, device="cpu")
    return bundle, params, tree_map(lambda t: t.to(device), params)


def _lm_close(got, want, what):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=LM_ATOL,
                               rtol=LM_RTOL, err_msg=what)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "h2o_danube_1_8b",
                                  "mixtral_8x7b", "mamba2_2_7b",
                                  "zamba2_2_7b", "whisper_medium"])
def test_cuda_lm_prefill_and_decode_match_cpu(card, arch):
    """The smoke LMs on the card against the port's CPU path on the same
    weights: prefill logits and every cache entry (17 tokens, past the SWA
    window of 16; Whisper also encodes 8 seeded frames, its smoke
    ``cross_len``), then one decode step's logits and cache."""
    from repro_torch.launch.serve import _fit
    bundle, cpu, dev = _lm(arch, card)
    cfg = bundle.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.cross_len, cfg.d_model)).astype(np.float32))
    want, wcache = bundle.prefill(cpu, batch)
    got, cache = bundle.prefill(dev, {k: v.to(card)
                                      for k, v in batch.items()})
    _lm_close(got, want, "prefill logits")
    assert set(cache) == set(wcache)
    for k in cache:
        _lm_close(cache[k], wcache[k], f"prefill {k}")
    spec, _ = bundle.cache_spec(2, 18)
    wcache = {k: _fit(wcache[k], s.shape) for k, s in spec.items()}
    cache = {k: v.to(card, copy=True) for k, v in wcache.items()}
    nxt = torch.tensor([5, 9], dtype=torch.int32)
    want, wcache = bundle.decode(cpu, wcache, {"tokens": nxt, "pos": 17})
    got, cache = bundle.decode(dev, cache, {"tokens": nxt.to(card),
                                            "pos": 17})
    _lm_close(got, want, "decode logits")
    for k in cache:
        _lm_close(cache[k], wcache[k], f"decode {k}")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x7b",
                                  "mamba2_2_7b", "zamba2_2_7b",
                                  "whisper_medium"])
def test_cuda_lm_decode_step_is_sync_free(card, arch):
    """A decode step reads nothing back from the card: it runs under
    ``set_sync_debug_mode("error")`` with a Python position (a fill on the
    card) and with a position already on the card."""
    bundle, _, dev = _lm(arch, card)
    spec, _ = bundle.cache_spec(2, 32)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=card)
             for k, s in spec.items()}
    toks = torch.tensor([1, 2], device=card)
    pos_t = torch.tensor(21, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bundle.decode(dev, cache, {"tokens": toks, "pos": 20})
        logits, _ = bundle.decode(dev, cache, {"tokens": toks,
                                               "pos": pos_t})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits.float()).all()


def test_cuda_zamba2_7b_graphed_decode_equals_eager(card, monkeypatch):
    """``serve`` replays the published Zamba2 layout's decode steps from
    one CUDA graph, captured afresh each call; with a block listener on
    it decodes eagerly.  In bf16 both give the same tokens and last
    logits bit for bit, and a second graphed call repeats them."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as S
    from repro_torch.models import build_model
    from repro_torch.models import zamba2 as Z
    bundle = build_model(get_smoke_config("zamba2_7b"))
    params = bundle.init(seed=0, dtype=torch.bfloat16, device=card)
    prompts = torch.randint(0, bundle.cfg.vocab_size, (3, 13),
                            generator=torch.Generator().manual_seed(0))
    prompts = prompts.to(card)
    graphed = []
    real = S._graphed_decode
    monkeypatch.setattr(S, "_graphed_decode",
                        lambda *a: graphed.append(1) or real(*a))
    first = S.serve(bundle, params, prompts, 9)
    again = S.serve(bundle, params, prompts, 9)
    assert len(graphed) == 2

    def listener(*_):
        pass

    Z.add_block_listener(listener)
    try:
        assert not bundle.graph_decode()
        eager = S.serve(bundle, params, prompts, 9)
    finally:
        Z.remove_block_listener(listener)
    assert len(graphed) == 2 and bundle.graph_decode()
    for out in (again, eager):
        np.testing.assert_array_equal(out["tokens"], first["tokens"])
        assert torch.equal(out["logits"], first["logits"])


# ---------------------------------------------- the LM on a spoofed mesh

def _spoofed(shape, axes, device):
    """``shape`` over ``axes`` as spoofed shards of one ``device``."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device=device, spoof=int(np.prod(shape)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,shape", [("qwen3_moe_235b_a22b", (2, 4)),
                                        ("mixtral_8x7b", (1, 8))])
def test_cuda_meshed_moe_matches_cpu(card, arch, shape, dtype):
    """``moe_ffn_sharded`` in EP mode (qwen3, 2 experts a shard) and TP
    mode (mixtral, 12 of d_ff a shard) on a spoofed ``cuda:0`` mesh: the
    card's run repeats bit for bit; in float32 it equals the same mesh on
    the CPU within the summation order (rtol 1e-5, 1e-5 of the output's
    scale).  In bf16 the router's logits round per device, so a token
    whose k-th and next expert lie within a bf16 ulp may route otherwise
    on the CPU (one token of 256 did on the H100): bf16 is held to
    repeatability here, and end to end by ``chip_smoke.py``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.parallel.moe import moe_ffn_sharded
    cfg = get_smoke_config(arch)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    lp = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
          .to(dt) for k, s in (("router", (d, e)), ("we_gate", (e, d, f)),
                               ("we_up", (e, d, f)), ("we_down", (e, f, d)))}
    x = torch.from_numpy(rng.normal(size=(4, 64, d)).astype(np.float32)).to(dt)
    want, aux_w = moe_ffn_sharded(x, lp, cfg,
                                  _spoofed(shape, ("data", "model"), "cpu"))
    mesh = _spoofed(shape, ("data", "model"), card)
    on_card = {k: v.to(card) for k, v in lp.items()}
    got, aux = moe_ffn_sharded(x.to(card), on_card, cfg, mesh)
    again, _ = moe_ffn_sharded(x.to(card), on_card, cfg, mesh)
    assert torch.equal(got, again) and got.dtype == dt
    assert torch.isfinite(got.float()).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_cuda_sp_attention_matches_cpu(card, dtype, window):
    """The SP attention on a spoofed (2, 4) ``cuda:0`` mesh against the
    CPU's (float32: 1e-5; bf16: 2e-2, the rounding of each shard's
    output), and ``sp_cache_update`` equal to the CPU's at a slot inside,
    at a shard's edge and outside every shard."""
    from repro_torch.parallel.decode import make_sp_attention, sp_cache_update
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    b, h, kh, hd, c, pos = 4, 8, 2, 16, 32, 20
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dt) for s in ((b, h, hd), (b, kh, c, hd),
                                   (b, kh, c, hd)))
    slot_pos = torch.where(torch.arange(c) <= pos, torch.arange(c), -1)
    want = make_sp_attention(_spoofed((2, 4), ("data", "model"), "cpu"))(
        q, ck, cv, slot_pos, torch.tensor(pos), window)
    mesh = _spoofed((2, 4), ("data", "model"), card)
    got = make_sp_attention(mesh)(q.to(card), ck.to(card), cv.to(card),
                                  slot_pos.to(card),
                                  torch.tensor(pos, device=card), window)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=tol, rtol=tol)
    kn, vn = (torch.from_numpy(rng.normal(size=(b, kh, hd)).astype(
        np.float32)).to(dt) for _ in range(2))
    cpu_mesh = _spoofed((2, 4), ("data", "model"), "cpu")
    for slot in (5, 8, 40):
        wk, wv = sp_cache_update(ck.clone(), cv.clone(), kn, vn, slot,
                                 cpu_mesh)
        gk, gv = sp_cache_update(ck.to(card), cv.to(card), kn.to(card),
                                 vn.to(card), torch.tensor(slot, device=card),
                                 mesh)
        assert torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv)


def test_cuda_sp_decode_step_is_sync_free(card):
    """A smoke InternLM2 decode step through the SP attention on a spoofed
    (1, 4) ``cuda:0`` mesh reads nothing back from the card."""
    from repro_torch.parallel.decode import make_sp_attention
    from repro_torch.parallel.sharding import DECODE_RULES_SP, activate
    bundle, _, dev = _lm("internlm2_1_8b", card)
    mesh = _spoofed((1, 4), ("data", "model"), card)
    attn = make_sp_attention(mesh)
    spec, _ = bundle.cache_spec(2, 32)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=card)
             for k, s in spec.items()}
    toks = torch.tensor([1, 2], device=card)
    with activate(mesh, DECODE_RULES_SP):
        bundle.decode(dev, cache, {"tokens": toks, "pos": 20},
                      attn_impl=attn)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = bundle.decode(dev, cache, {"tokens": toks, "pos": 21},
                                      attn_impl=attn)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits.float()).all()


def test_cuda_pipeline_matches_cpu_and_sequential(card):
    """``pipeline_forward`` over a spoofed 4-stage ``cuda:0`` mesh: equal
    to the card's ``sequential_reference`` bit for bit, and to the CPU's
    pipeline within float32 rounding (1e-5)."""
    from repro_torch.parallel.pipeline import (pipeline_forward,
                                               sequential_reference)
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.normal(size=(4, 8, 8)) * 0.3).astype(
        np.float32))
    xs = torch.from_numpy(rng.normal(size=(6, 3, 8)).astype(np.float32))

    def layer_fn(p, x):
        return torch.tanh(x @ p["w"])

    want = pipeline_forward(layer_fn, {"w": w}, xs,
                            _spoofed((4,), ("stage",), "cpu"))
    params = {"w": w.to(card)}
    got = pipeline_forward(layer_fn, params, xs.to(card),
                           _spoofed((4,), ("stage",), card))
    assert torch.equal(got, sequential_reference(layer_fn, params,
                                                 xs.to(card)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------- LM training

# card against CPU, an InternLM2-1.8B step at full width cut to 2 layers
# (bf16 activations: cuBLAS and the CPU sum in other orders): the loss
# within 0.01, the whole gradient within 0.02 of its norm, each leaf within
# 0.05 of its norm
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_LEAF_RTOL = 0.01, 0.02, 0.05


def _train_cut(device, layers=2, seq=512, batch=2):
    """InternLM2-1.8B at full width cut to ``layers`` layers, float32
    parameters seeded on the CPU and copied to ``device``, and a token
    pipeline batch of ``batch`` x ``seq`` on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), n_layers=layers)
    bundle = build_model(cfg)
    cpu = bundle.init(seed=0, device="cpu")
    return (bundle, cpu, tree_map(lambda t: t.to(device), cpu),
            batch_fn_for(cfg, seq, batch, "cpu")(0))


def test_cuda_lm_train_step_matches_cpu(card):
    """One train step of InternLM2-1.8B at full width cut to 2 layers, seq
    512: the loss and the gradient on the card against the CPU's, at the
    bf16 bounds above; the step's new state finite."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.engine.train_loop import (_value_and_grad,
                                               init_train_state,
                                               make_train_step)
    from repro_torch.optim.adamw import AdamWConfig
    bundle, cpu, dev, batch = _train_cut(card)
    want_loss, want = _value_and_grad(bundle.loss, cpu, batch)
    on_card = {k: v.to(card) for k, v in batch.items()}
    loss, grads = _value_and_grad(bundle.loss, dev, on_card)
    assert abs(loss.item() - want_loss.item()) <= TRAIN_LOSS_ATOL
    got = [g.cpu() for g in tree_leaves(grads)]
    ref = tree_leaves(want)
    for g, w in zip(got, ref):
        assert (g - w).norm() <= TRAIN_LEAF_RTOL * w.norm()
    g, w = (torch.cat([x.reshape(-1) for x in t]) for t in (got, ref))
    assert (g - w).norm() <= TRAIN_GRAD_RTOL * w.norm()
    opt = AdamWConfig()
    new, metrics = make_train_step(bundle.loss, opt)(
        init_train_state(None, dev, opt).as_tree(), on_card)
    assert torch.equal(metrics["loss"], loss)
    assert all(torch.isfinite(t).all() for t in tree_leaves(new))


def test_cuda_lm_train_step_is_sync_free(card):
    """The same step (loss, gradient with remat, AdamW) reads nothing back
    from the card: it runs under ``set_sync_debug_mode("error")``; the
    loop's one read of the metrics comes after it."""
    from repro_torch.engine.train_loop import (init_train_state,
                                               make_train_step)
    from repro_torch.optim.adamw import AdamWConfig
    bundle, _, dev, batch = _train_cut(card)
    on_card = {k: v.to(card) for k, v in batch.items()}
    opt = AdamWConfig()
    step = make_train_step(bundle.loss, opt)
    state = init_train_state(None, dev, opt).as_tree()
    state, _ = step(state, on_card)            # warm: allocations, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(metrics["loss"]).all()


def _moe_grads(device, cfg, x, lp, w, shape):
    """The gradients of ``sum(moe_ffn_sharded(x) * w) + aux`` with respect
    to ``x`` and each weight, on a spoofed mesh of ``shape`` on
    ``device``."""
    from repro_torch.parallel.moe import moe_ffn_sharded
    xs = x.to(device).requires_grad_(True)
    ws = {k: v.to(device).requires_grad_(True) for k, v in lp.items()}
    y, aux = moe_ffn_sharded(xs, ws, cfg,
                             _spoofed(shape, ("data", "model"), device))
    val = (y * w.to(device)).sum() + aux
    names = sorted(ws)
    return [g.cpu() for g in torch.autograd.grad(
        val, [xs] + [ws[k] for k in names])]


def _moe_case(arch, seed=0):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    lp = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
          for k, s in (("router", (d, e)), ("we_gate", (e, d, f)),
                       ("we_up", (e, d, f)), ("we_down", (e, f, d)))}
    x, w = (torch.from_numpy(rng.normal(size=(4, 64, d)).astype(np.float32))
            for _ in range(2))
    return cfg, x, lp, w


@pytest.mark.parametrize("arch,shape", [("qwen3_moe_235b_a22b", (2, 4)),
                                        ("mixtral_8x7b", (1, 2))])
def test_cuda_meshed_moe_gradient_matches_cpu(card, arch, shape):
    """The meshed MoE's gradient (x and every weight) in float32 on a
    spoofed ``cuda:0`` mesh, EP and TP mode: repeats bit for bit, and
    equals the same mesh on the CPU within the summation order (rtol 1e-5,
    1e-5 of each gradient's scale)."""
    cfg, x, lp, w = _moe_case(arch)
    want = _moe_grads("cpu", cfg, x, lp, w, shape)
    got = _moe_grads(card, cfg, x, lp, w, shape)
    again = _moe_grads(card, cfg, x, lp, w, shape)
    for g, a, ref in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_cuda_meshed_moe_backward_runs_without_tf32(card, monkeypatch):
    """The meshed MoE's backward multiplies in float32 whatever the
    caller's TF32 setting: with TF32 forced on for the whole process its
    gradients equal those of a run with TF32 off, bit for bit.  The check
    can fail: with the router's and the experts' products' backward left
    to autograd (``exact_matmul`` replaced by ``torch.matmul``, the
    forward still inside its ``exact_float32`` block), TF32 on moves the
    gradients."""
    from repro_torch.parallel import moe as MOE
    cfg, x, lp, w = _moe_case("mixtral_8x7b", seed=1)
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)

    def grads(tf32: bool):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return _moe_grads(card, cfg, x, lp, w, (1, 2))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    exact = grads(False)
    assert all(torch.equal(a, b) for a, b in zip(grads(True), exact))
    monkeypatch.setattr(MOE, "exact_matmul", torch.matmul)
    assert all(torch.equal(a, b) for a, b in zip(grads(False), exact))
    assert not all(torch.equal(a, b) for a, b in zip(grads(True), exact))


@pytest.mark.parametrize("arch,mesh_shape", [("internlm2_1_8b", (4, 2)),
                                             ("mixtral_8x7b", (1, 2))])
def test_cuda_dryrun_counts_equal_meta(card, arch, mesh_shape):
    """The dry-run's count of a smoke training step (64 x 8 tokens) on a
    spoofed mesh is the same on the card as on meta tensors: FLOPs,
    bytes, collectives, argument, output, donated and peak live bytes
    (the Mixtral step runs the meshed MoE on a (1, 2) mesh)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("train_4k", 64, 8, "train")
    n = mesh_shape[0] * mesh_shape[1]
    tallies = {}
    for dev in ("meta", card):
        mesh = make_mesh(mesh_shape, ("data", "model"), device=dev, spoof=n)
        traced, _ = D.lower_cell(arch, shape, mesh, device=dev, cfg=cfg,
                                 full_depth=True)
        tallies[torch.device(dev).type] = traced.tally
    assert tallies["cuda"] == tallies["meta"]
    assert tallies["cuda"]["dot_flops"] > 0
