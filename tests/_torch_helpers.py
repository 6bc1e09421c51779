"""Shared builders for the PyTorch port's tests: the same seeded numpy
layer specs mapped by the reference package and by the port, and the
field-by-field comparisons of their results."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

import repro.core.layers as ref_layers
from repro.core.accelerator import map_model as ref_map_model
from repro.core.energy import AcceleratorSpec as RefSpec
from repro.core.lif import LIFParams as RefLIF

import repro_torch.core.layers as port_layers
from repro_torch.core.accelerator import map_model as port_map_model
from repro_torch.core.energy import AcceleratorSpec as PortSpec
from repro_torch.core.lif import LIFParams as PortLIF

STAT_FIELDS = ("cycles", "rows_touched", "engine_ops", "events",
               "sn_bytes_touched")


def pruned_mlp(rng, sizes, density=0.5, scale=0.5):
    ws = []
    for i in range(len(sizes) - 1):
        w = rng.normal(0, scale, (sizes[i], sizes[i + 1]))
        th = np.quantile(np.abs(w), 1 - density)
        w[np.abs(w) < th] = 0
        ws.append(w.astype(np.float32))
    return ws


def case_layers(case: dict, rng):
    """Layer descriptions of a golden-equivalence case as
    ``(kind, payload)`` pairs, drawn exactly as the reference suite draws
    them (tests/test_equivalence_prop.py::build_case)."""
    out = []
    shape = tuple(case["in_shape"])
    for ld in case["layers"]:
        if ld["kind"] == "dense":
            n_in = int(np.prod(shape))
            w = rng.normal(0, 0.6, (n_in, ld["n_out"]))
            w[rng.random(w.shape) > ld["density"]] = 0
            if (w != 0).sum() == 0:
                w[0, 0] = 0.5
            out.append(("dense", dict(w=w.astype(np.float32))))
            shape = (ld["n_out"], 1, 1)
        elif ld["kind"] == "conv":
            k = rng.normal(0, 0.8, (ld["c_out"], shape[0], ld["k"], ld["k"]))
            k[rng.random(k.shape) > ld["density"]] = 0
            if (k != 0).sum() == 0:
                k[0, 0, 0, 0] = 0.5
            kw = dict(kernel=k.astype(np.float32), in_shape=shape,
                      stride=ld["stride"], padding=ld["padding"])
            out.append(("conv", kw))
            shape = ref_layers.Conv2d(**kw).out_shape
        elif ld["kind"] == "pool":
            out.append(("pool", dict(in_shape=shape, pool=ld["pool"])))
            shape = ref_layers.SumPool2d(shape, ld["pool"]).out_shape
        else:
            raise ValueError(ld["kind"])
    return out


def _specs(layers, mod):
    specs = []
    for kind, kw in layers:
        if kind == "dense":
            specs.append(mod.Dense(**kw))
        elif kind == "conv":
            specs.append(mod.Conv2d(**kw))
        else:
            specs.append(mod.SumPool2d(kw["in_shape"], kw["pool"]))
    return specs


def map_both(layers, n_engines, n_caps, *, beta=0.8, threshold=0.7,
             weight_mem_bytes=1 << 20, **kw):
    """``(reference mapped model, port mapped model)`` of the same layers.
    ``layers`` is a list of bare matrices or ``(kind, payload)`` pairs."""
    if layers and isinstance(layers[0], np.ndarray):
        layers = [("dense", dict(w=w)) for w in layers]
    n = len(layers)
    ref = ref_map_model(
        _specs(layers, ref_layers),
        RefSpec("t", n_cores=n, n_engines=n_engines, n_caps=n_caps,
                weight_mem_bytes=weight_mem_bytes),
        lif=RefLIF(beta=beta, threshold=threshold), **kw)
    port = port_map_model(
        _specs(layers, port_layers),
        PortSpec("t", n_cores=n, n_engines=n_engines, n_caps=n_caps,
                 weight_mem_bytes=weight_mem_bytes),
        lif=PortLIF(beta=beta, threshold=threshold), **kw)
    return ref, port


def spikes_for(rng, b, t, n_in, p):
    return (rng.random((b, t, n_in)) < p).astype(np.float32)


def assert_stats_equal(got, want, ctx=""):
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{ctx} {f}")
    assert got.mem_e_peak == want.mem_e_peak, f"{ctx} mem_e_peak"


def assert_batched_equals_oracle(res, oracle_results, n_layers, ctx=""):
    """A port ``BatchedRunResult`` against the reference oracle's per-sample
    ``RunResult`` list: spikes, stats, utilisation, overflow, energy."""
    assert res.out_spikes.shape[0] == len(oracle_results)
    for b, oracle in enumerate(oracle_results):
        c = f"{ctx} sample {b}"
        np.testing.assert_array_equal(res.out_spikes[b], oracle.out_spikes,
                                      err_msg=f"{c} spikes")
        for li, (bs, os_) in enumerate(zip(res.sample_stats(b),
                                           oracle.per_layer_stats)):
            assert_stats_equal(bs, os_, f"{c} layer {li}")
        for li in range(n_layers):
            np.testing.assert_array_equal(res.per_layer_util[li][b],
                                          oracle.per_layer_util[li],
                                          err_msg=f"{c} layer {li} util")
            np.testing.assert_array_equal(res.overflow[li][b],
                                          oracle.overflow[li],
                                          err_msg=f"{c} layer {li} overflow")
        e = res.sample_energy(b)
        assert e.total_ops == oracle.energy.total_ops, c
        assert e.tops_per_w == oracle.energy.tops_per_w, c


# ------------------------------------------------- serving-fabric twins

def demo_models(kind: str = "mlp", seed: int = 0):
    """``(reference packed model, port packed model)`` of the serve_snn
    smoke demo: the reference on its packed-operand route (the route its
    Pallas kernels run on this JAX), the port on the CPU."""
    from repro.launch.serve_snn import build_demo_model as ref_build

    from repro_torch.launch.serve_snn import build_demo_model as port_build
    return (ref_build(kind, smoke=True, seed=seed).pack(packed_ops=True),
            port_build(kind, smoke=True, seed=seed).pack(device="cpu"))


def policies(batch_sizes, time_steps):
    """The same bucket grid as ``(reference policy, port policy)``."""
    from repro.engine import BucketPolicy as RefPolicy

    from repro_torch.engine import BucketPolicy
    return (RefPolicy(batch_sizes=tuple(batch_sizes),
                      time_steps=tuple(time_steps)),
            BucketPolicy(batch_sizes=tuple(batch_sizes),
                         time_steps=tuple(time_steps)))


def dispatches(server):
    """A server's dispatch sequence: every telemetry field but the
    wall-measured ``seconds``."""
    return [{k: v for k, v in rec.items() if k != "seconds"}
            for rec in server.telemetry]


def rejections(server):
    return [(r.rid, r.reason, r.detail, r.at, r.model)
            for r in server.rejections]


def assert_results_equal(got, want, ctx=""):
    """Two RequestResults (port, reference), every surface bit for bit."""
    np.testing.assert_array_equal(got.out_spikes, np.asarray(want.out_spikes),
                                  err_msg=f"{ctx} spikes")
    assert len(got.stats) == len(want.stats), ctx
    for li, (a, b) in enumerate(zip(got.stats, want.stats)):
        assert_stats_equal(a, b, f"{ctx} layer {li}")
        np.testing.assert_array_equal(got.util[li], want.util[li])
        np.testing.assert_array_equal(got.overflow[li], want.overflow[li])
    if got.stats:
        assert vars(got.energy()) == vars(want.energy()), ctx


class Twin:
    """The reference's StreamServer (packed route) and the port's, built
    with the same arguments on their own VirtualClocks and driven in
    lockstep: every call goes to both, and :meth:`check` holds their
    dispatch sequences, rejections, metrics snapshots and served results
    equal.  ``ref_model``/``port_model`` are models or registries;
    ``policy`` is ``(batch_sizes, time_steps)``."""

    def __init__(self, ref_model, port_model, *, policy=None, **kw):
        from repro.engine import StreamServer as RefServer
        from repro.engine import VirtualClock as RefClock

        from repro_torch.engine import StreamServer, VirtualClock
        ref_kw, port_kw = dict(kw), dict(kw)
        if policy is not None:
            ref_kw["policy"], port_kw["policy"] = policies(*policy)
        self.ref = RefServer(ref_model, clock=RefClock(), **ref_kw)
        self.port = StreamServer(port_model, clock=VirtualClock(), **port_kw)
        self.done_ref: dict = {}
        self.done_port: dict = {}

    def _both(self, name, *args, **kw):
        a = getattr(self.ref, name)(*args, **kw)
        b = getattr(self.port, name)(*args, **kw)
        return a, b

    def submit(self, stream, **kw):
        a, b = self._both("submit", stream, **kw)
        assert a == b, f"rids differ: reference {a}, port {b}"
        return b

    def advance(self, dt):
        self.ref.clock.advance(dt)
        self.port.clock.advance(dt)

    def _collecting(self, name, *args, **kw):
        a, b = self._both(name, *args, **kw)
        assert [r for r, _ in a] == [r for r, _ in b], name
        self.done_ref.update(a)
        self.done_port.update(b)
        return b

    def poll(self):
        return self._collecting("poll")

    def flush(self, *args, **kw):
        return self._collecting("flush", *args, **kw)

    def collect(self):
        return self._collecting("collect")

    def serve_trace(self, trace, **kw):
        from repro.engine import serve_trace as ref_serve_trace

        from repro_torch.engine import serve_trace
        ref_res, ref_rids = ref_serve_trace(self.ref, trace, **kw)
        res, rids = serve_trace(self.port, trace, **kw)
        assert rids == ref_rids
        self.done_ref.update(ref_res)
        self.done_port.update(res)
        return res, rids

    def check(self, *, wall_keys=()):
        """Everything the two servers report, equal: dispatches, telemetry
        record fields (wall ``seconds`` aside), rejections, every
        ``snapshot()`` key but the named wall-clock ones, and every served
        result bit for bit."""
        assert dispatches(self.port) == dispatches(self.ref)
        assert rejections(self.port) == rejections(self.ref)
        a, b = self.port.metrics.snapshot(), self.ref.metrics.snapshot()
        assert tuple(a) == tuple(b)
        for k in a:
            if k not in wall_keys:
                assert a[k] == b[k], f"metric {k}: port {a[k]} vs {b[k]}"
        assert self.done_port.keys() == self.done_ref.keys()
        for rid, res in self.done_port.items():
            assert_results_equal(res, self.done_ref[rid], f"rid {rid}")


# ------------------------------------------------------ training twins

def oracle_membranes(specs, lif, spikes) -> list[np.ndarray]:
    """The integrated membrane ``beta * v + I`` of every layer at every
    step, ``[T, ..., n]`` each, by the reference's dense oracle arithmetic
    (``repro.core.accelerator.reference_forward``: float32 currents from
    each spec's unrolled matrix, the LIF roll-out in numpy), on a
    time-major raster ``[T, B, n_in]`` or ``[T, n_in]``."""
    x = np.asarray(spikes, dtype=np.float32)
    beta = np.float32(lif.beta)
    out = []
    for spec in specs:
        cur = x @ np.asarray(ref_layers.as_layer_spec(spec).unroll(),
                             dtype=np.float32)
        v = np.zeros(cur.shape[1:], np.float32)
        vi_t, s_t = [], []
        for t in range(cur.shape[0]):
            vi = beta * v + cur[t]
            s = (vi >= np.float32(lif.threshold)).astype(np.float32)
            v = np.where(s > 0, np.float32(lif.v_reset), vi)
            vi_t.append(vi)
            s_t.append(s)
        out.append(np.stack(vi_t))
        x = np.stack(s_t)
    return out


def assert_spikes_match(ref, port, ref_membrane, threshold, ulps=4, ctx=""):
    """Two spike trains equal, except where the reference's membrane lies
    within ``ulps`` ulp of the threshold: the float32 sums of the two
    packages may order their terms differently, and only a membrane that
    close to the threshold may then fire in one and not the other."""
    ref, port = np.asarray(ref), np.asarray(port)
    diff = ref != port
    if not diff.any():
        return
    near = (np.abs(np.asarray(ref_membrane, np.float32) - np.float32(threshold))
            <= ulps * np.spacing(np.float32(threshold)))
    bad = diff & ~near
    assert not bad.any(), (
        f"{ctx}: {int(bad.sum())} of {int(diff.sum())} differing spikes lie "
        f"more than {ulps} ulp from the threshold (a flip is accepted only "
        f"where the reference membrane is within {ulps} ulp of it)")


def assert_grads_close(ref, port, rtol=1e-4, atol_frac=1e-6, ctx=""):
    """Gradient leaves held at ``rtol`` and an absolute floor of
    ``atol_frac * max|g|`` per leaf: the two packages sum each product in
    a different float32 order, and the surrogate derivative multiplies
    those differences through every layer and step."""
    for i, (a, b) in enumerate(zip(ref, port)):
        a = np.asarray(a)
        b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
        np.testing.assert_allclose(
            b, a, rtol=rtol, atol=atol_frac * float(np.abs(a).max()),
            err_msg=f"{ctx} grad leaf {i}")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The prelude of a reference script: on JAX 0.9 ``jax.make_mesh`` builds
# Explicit axes, under which the JAX package's meshed prefill and pipeline
# raise; its meshes are built here with Auto axes, as on JAX 0.4.
AUTO_MESH = """
import jax
from jax.sharding import AxisType

def auto_mesh(shape, axes):
    return jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))
"""


def run_reference(script: str, devices: int = 8) -> str:
    """Run ``script`` (after :data:`AUTO_MESH`) in a fresh interpreter on
    ``devices`` spoofed XLA CPU devices; its standard output."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    p = subprocess.run([sys.executable, "-c", AUTO_MESH + script],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-4000:])
    return p.stdout


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as flat ``a/b`` keys (for ``np.savez``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nested_tree(flat, prefix: str) -> dict:
    """The keys of ``flat`` under ``prefix`` as the nested dict they came
    from (:func:`flat_tree`)."""
    out: dict = {}
    for key in flat.keys():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return out
