"""The port's serving front end and packed-operand route against the
reference: ``run_bucketed`` against the numpy oracle, the packed route
against ``repro.engine.run_batched(model.pack(packed_ops=True))`` at
2/4/8 bits, and the slice end to end from the reference MLP's parameters."""

import numpy as np
import pytest
import torch

from _torch_helpers import (STAT_FIELDS, assert_stats_equal, map_both,
                            pruned_mlp, spikes_for)
from repro.core.accelerator import run as ref_run
from repro.engine import batched_run as ref_br
from repro.engine import serving as ref_serving

from repro_torch.engine import batched_run as br
from repro_torch.engine import serving

torch.set_num_threads(1)


def assert_results_equal(a, b, ctx=""):
    """Two batched results (port vs reference engine), field for field."""
    np.testing.assert_array_equal(a.out_spikes, np.asarray(b.out_spikes),
                                  err_msg=f"{ctx} spikes")
    assert len(a.per_layer_stats) == len(b.per_layer_stats)
    for li, (sa, sb) in enumerate(zip(a.per_layer_stats, b.per_layer_stats)):
        for f in STAT_FIELDS + ("mem_e_peak",):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                          err_msg=f"{ctx} layer {li} {f}")
        np.testing.assert_array_equal(a.per_layer_util[li],
                                      b.per_layer_util[li])
        np.testing.assert_array_equal(a.overflow[li], b.overflow[li])
    for s in range(a.batch):
        assert a.sample_energy(s).tops_per_w == b.sample_energy(s).tops_per_w


@pytest.mark.parametrize("quant_bits", [2, 4, 8, [8, 4, 2]])
def test_packed_route_matches_reference_packed_route(quant_bits):
    rng = np.random.default_rng(3)
    ref, port = map_both(pruned_mlp(rng, (20, 24, 12, 6), density=0.6), 4, 8,
                         quant_bits=quant_bits)
    spikes = spikes_for(rng, 3, 6, 20, 0.4)
    packed = port.pack(packed_ops=True, device="cpu")
    assert all(l.w_packed is not None for l in packed.layers)
    got = br.run_batched(packed, spikes, max_events=9)
    want = ref_br.run_batched(ref.pack(packed_ops=True), spikes, max_events=9)
    assert_results_equal(got, want, f"bits={quant_bits}")
    # and the packed route equals the port's dense route
    dense = br.run_batched(port.pack(packed_ops=False, device="cpu"), spikes,
                           max_events=9)
    np.testing.assert_array_equal(got.out_spikes, dense.out_spikes)


def test_run_bucketed_matches_oracle():
    """Variable-length requests padded into buckets come back bit-exact
    with the oracle run on each request alone."""
    rng = np.random.default_rng(4)
    ref, port = map_both(pruned_mlp(rng, (16, 20, 8), density=0.6), 4, 8)
    streams = [spikes_for(rng, 1, t, 16, 0.4)[0] for t in (3, 9, 5, 16, 1)]
    telemetry = []
    policy = serving.BucketPolicy(batch_sizes=(1, 4), time_steps=(4, 16))
    n0 = br.trace_count()
    res = serving.run_bucketed(port, streams, policy=policy, max_events=7,
                               telemetry=telemetry, device="cpu")
    assert br.trace_count() - n0 <= policy.n_buckets
    for r, s in zip(res, streams):
        oracle = ref_run(ref, s, max_events=7)
        np.testing.assert_array_equal(r.out_spikes, oracle.out_spikes)
        for a, b in zip(r.stats, oracle.per_layer_stats):
            assert_stats_equal(a, b)
        for a, b in zip(r.util, oracle.per_layer_util):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r.overflow, oracle.overflow):
            np.testing.assert_array_equal(a, b)
        assert vars(r.energy()) == vars(oracle.energy)
    assert serving.TELEMETRY_KEYS == ref_serving.TELEMETRY_KEYS
    assert [set(t) for t in telemetry] == \
        [set(serving.TELEMETRY_KEYS)] * len(telemetry)
    assert sum(t["n_requests"] for t in telemetry) == len(streams)


def test_plan_and_policy_match_reference():
    lengths = [3, 9, 5, 16, 1, 30, 8, 8, 2]
    for policy_args in (dict(batch_sizes=(1, 4), time_steps=(4, 16, 32)),
                        dict(batch_sizes=(2,), time_steps=(32,))):
        got = serving.plan_batches(lengths,
                                   serving.BucketPolicy(**policy_args))
        want = ref_serving.plan_batches(lengths,
                                        ref_serving.BucketPolicy(**policy_args))
        assert [(p.indices, p.b_pad, p.t_pad) for p in got] == \
            [(p.indices, p.b_pad, p.t_pad) for p in want]
    for max_batch in (1, 5, 16):
        a = serving.BucketPolicy.covering(lengths, max_batch=max_batch)
        b = ref_serving.BucketPolicy.covering(lengths, max_batch=max_batch)
        assert (a.batch_sizes, a.time_steps) == (b.batch_sizes, b.time_steps)
    p = serving.BucketPolicy(time_steps=(8,))
    assert p.with_time_bucket(20).time_steps == \
        ref_serving.BucketPolicy(time_steps=(8,)).with_time_bucket(20).time_steps


def test_policy_for_mesh_divisibility():
    """Every batch bucket a multiple of the mesh's size, the reference's
    grid exactly."""
    for n in (1, 2, 3, 8):
        p = serving.BucketPolicy.for_mesh(n, batch_sizes=(1, 4, 16))
        assert all(b % n == 0 for b in p.batch_sizes)
        want = ref_serving.BucketPolicy.for_mesh(n, batch_sizes=(1, 4, 16))
        assert (p.batch_sizes, p.time_steps) == \
            (want.batch_sizes, want.time_steps)


def test_policy_covering_rounds_to_the_mesh():
    lengths = [3, 17, 9]
    for n, max_batch in ((2, 8), (3, 16), (4, 4)):
        p = serving.BucketPolicy.covering(lengths, n_shards=n,
                                          max_batch=max_batch)
        assert p.time_steps[-1] >= 17 and p.max_batch >= max_batch
        assert all(b % n == 0 for b in p.batch_sizes)
        want = ref_serving.BucketPolicy.covering(lengths, n_shards=n,
                                                 max_batch=max_batch)
        assert (p.batch_sizes, p.time_steps) == \
            (want.batch_sizes, want.time_steps)


def test_run_bucketed_on_a_mesh_matches_one_device_and_oracle():
    """``mesh=`` routes every engine call through run_sharded; the default
    policy is rounded to the mesh, and every request equals the
    single-device run and the oracle's run of it alone."""
    from repro_torch.engine import snn_serve_mesh
    rng = np.random.default_rng(11)
    ref, port = map_both(pruned_mlp(rng, (16, 20, 8), density=0.6), 4, 8)
    streams = [spikes_for(rng, 1, t, 16, 0.4)[0]
               for t in (3, 9, 5, 16, 1, 7, 12)]
    packed = port.pack(device="cpu")
    telemetry = []
    mesh = snn_serve_mesh(device="cpu", spoof=2)
    res = serving.run_bucketed(packed, streams, mesh=mesh,
                               telemetry=telemetry)
    assert all(t["b_pad"] % 2 == 0 for t in telemetry)
    one = serving.run_bucketed(packed, streams)
    for r, o, s in zip(res, one, streams):
        oracle = ref_run(ref, s)
        for got in (r, o):
            np.testing.assert_array_equal(got.out_spikes, oracle.out_spikes)
            for a, b in zip(got.stats, oracle.per_layer_stats):
                assert_stats_equal(a, b)
        assert vars(r.energy()) == vars(oracle.energy)


def test_overlong_requests():
    rng = np.random.default_rng(5)
    ref, port = map_both(pruned_mlp(rng, (8, 6)), 2, 4)
    packed = port.pack(device="cpu")
    streams = [spikes_for(rng, 1, t, 8, 0.5)[0] for t in (3, 12)]
    policy = serving.BucketPolicy(batch_sizes=(2,), time_steps=(4, 8))
    with pytest.raises(serving.OverlongRequestError) as e:
        serving.run_bucketed(packed, streams, policy=policy)
    assert e.value.requests == [(1, 12)]
    res = serving.run_bucketed(packed, streams, policy=policy,
                               overlong="extend")
    np.testing.assert_array_equal(res[1].out_spikes,
                                  ref_run(ref, streams[1]).out_spikes)


def test_slice_end_to_end_from_reference_params():
    """The reference MLP's own initialised parameters, pruned, carried
    across as numpy, mapped and served by the port, equal the reference's
    map + packed-route serving and its oracle."""
    import jax
    from repro.core.accelerator import map_model as ref_map
    from repro.core.energy import AcceleratorSpec as RefSpec
    from repro.snn.mlp import SNNConfig, init_snn

    from repro_torch.configs.menage_paper import SNNConfig as PortSNN
    from repro_torch.convert import specs_from_reference
    from repro_torch.core.accelerator import map_model
    from repro_torch.core.energy import AcceleratorSpec

    cfg = SNNConfig(layer_sizes=(64, 48, 10))
    params = [np.asarray(p) * 3 for p in init_snn(jax.random.key(1), cfg)]
    for p in params:
        p[np.abs(p) < np.median(np.abs(p))] = 0
    port_cfg = PortSNN(layer_sizes=cfg.layer_sizes)
    assert (port_cfg.lif.beta, port_cfg.lif.threshold, port_cfg.num_steps) \
        == (cfg.lif.beta, cfg.lif.threshold, cfg.num_steps)
    port = map_model(specs_from_reference(params),
                     AcceleratorSpec("s", 2, 4, 8, 1 << 20), lif=port_cfg.lif)
    ref = ref_map(params, RefSpec("s", 2, 4, 8, 1 << 20), lif=cfg.lif)
    rng = np.random.default_rng(6)
    streams = [spikes_for(rng, 1, t, 64, 0.3)[0] for t in (8, 5, 7, 2)]
    got = serving.run_bucketed(port, streams, device="cpu")
    want = ref_serving.run_bucketed(ref.pack(packed_ops=True), streams)
    assert sum(int(r.out_spikes.sum()) for r in got) > 0
    for g, w, s in zip(got, want, streams):
        np.testing.assert_array_equal(g.out_spikes, w.out_spikes)
        np.testing.assert_array_equal(g.out_spikes,
                                      ref_run(ref, s).out_spikes)
        for a, b in zip(g.stats, w.stats):
            assert_stats_equal(a, b)


def test_event_data_and_configs_match_reference():
    from repro.configs import menage_paper as ref_cfg
    from repro.data.events import EventDatasetConfig as RefData
    from repro.data.events import _class_rate_maps as ref_maps

    from repro_torch.configs import menage_paper as cfg
    from repro_torch.data.events import (EventDatasetConfig,
                                         _class_rate_maps,
                                         synthetic_event_dataset)
    for port_d, ref_d in ((EventDatasetConfig.nmnist_like(),
                           RefData.nmnist_like()),
                          (EventDatasetConfig.cifar10_dvs_like(down=8),
                           RefData.cifar10_dvs_like(down=8))):
        assert vars(port_d) == vars(ref_d)
        np.testing.assert_array_equal(_class_rate_maps(port_d),
                                      ref_maps(ref_d))
    assert cfg.NMNIST_SNN.layer_sizes == ref_cfg.NMNIST_SNN.layer_sizes
    assert cfg.CIFAR_SNN.layer_sizes[1:] == ref_cfg.CIFAR_SNN.layer_sizes[1:]
    assert cfg.CIFAR_SNN.layer_sizes[0] == 32768
    for a, b in ((cfg.NMNIST_SNN, ref_cfg.NMNIST_SNN),
                 (cfg.CIFAR_SNN, ref_cfg.CIFAR_SNN)):
        assert (a.lif.beta, a.lif.threshold, a.num_steps) == \
            (b.lif.beta, b.lif.threshold, b.num_steps)
    assert vars(cfg.ACCEL_1) == vars(ref_cfg.ACCEL_1)
    assert vars(cfg.ACCEL_2) == vars(ref_cfg.ACCEL_2)
    d = EventDatasetConfig.cifar10_dvs_like(down=16)
    spikes, labels = synthetic_event_dataset(d, 2, np.random.default_rng(0))
    assert spikes.shape == (20, d.num_steps, d.n_in)
    assert set(np.unique(spikes)) <= {0.0, 1.0}
    assert sorted(labels.tolist()) == sorted(list(range(10)) * 2)


# Calls served in turn on one model, each a list of request lengths in a
# (4, 8) bucket: shorter than the bucket, equal to it, mixed within it,
# and a long call before a short one on the same shape, where rows the
# staging buffer kept from the first call would show in the second.
STAGING_CASES = {"shorter": [[3, 5]], "equal": [[8, 8, 8, 8]],
                 "mixed": [[8, 2, 5]], "long_then_short": [[8, 8, 8], [2]]}


def _float_raster_plan(packed, streams, plan, max_events):
    """An engine call as a float32 raster: the requests zero-padded into
    the bucket, the forward on that raster, and the record's ``events``
    counted on each request's own ``> 0``."""
    padded = np.zeros((plan.b_pad, plan.t_pad, packed.n_in), np.float32)
    for row, i in enumerate(plan.indices):
        padded[row, :streams[i].shape[0]] = streams[i]
    outs = br._forward_impl(packed, torch.from_numpy(padded), max_events)
    res = br._finalize(packed, padded, [o.numpy() for o in outs],
                       max_events, None, True)
    results = [serving._slice_request(res, row, streams[i].shape[0], True)
               for row, i in enumerate(plan.indices)]
    record = {"events": int(sum((streams[i] > 0).sum()
                                for i in plan.indices)),
              "out_spikes": int(sum(res.out_spikes[row, :streams[i]
                                                   .shape[0]].sum()
                                    for row, i in enumerate(plan.indices)))}
    return results, record


@pytest.mark.parametrize("case", sorted(STAGING_CASES))
@pytest.mark.parametrize("packed_ops,bits", [(False, 8), (True, 4)])
def test_staged_mask_equals_the_float_raster_path(case, packed_ops, bits):
    """execute_plan stages its requests as a uint8 ``> 0`` mask in the
    model's staging buffer; its results and telemetry record equal, bit
    for bit, those of the float32 raster, on streams with negative,
    fractional and zero entries, on the dense and the packed route."""
    from repro_torch.core.accelerator import map_model
    from repro_torch.core.energy import AcceleratorSpec
    from repro_torch.core.lif import LIFParams

    rng = np.random.default_rng(40 + bits)
    model = map_model(pruned_mlp(rng, (24, 20, 8), density=0.6),
                      AcceleratorSpec("t", n_cores=2, n_engines=4, n_caps=8,
                                      weight_mem_bytes=1 << 20),
                      lif=LIFParams(beta=0.8, threshold=0.7),
                      quant_bits=bits)
    packed = model.pack(packed_ops=packed_ops, device="cpu")
    values = np.array([-1.5, -0.25, 0, 0, 0, 0, 0, 0.125, 1.0, 2.5],
                      np.float32)
    for seq, lengths in enumerate(STAGING_CASES[case]):
        streams = [rng.choice(values, size=(t, 24)) for t in lengths]
        plan = serving.BatchPlan(indices=tuple(range(len(streams))),
                                 b_pad=4, t_pad=8)
        got, record = serving.execute_plan(packed, streams, plan,
                                           max_events=9, seq=seq, ts=0.5)
        want, want_record = _float_raster_plan(packed, streams, plan, 9)
        mask = packed.staging[(4, 8)].mask
        assert mask.dtype == np.uint8 and list(packed.staging) == [(4, 8)]
        for row, s in enumerate(streams):
            np.testing.assert_array_equal(mask[row, :len(s)], s > 0)
        assert not mask[len(streams):].any()
        assert not any(mask[row, len(s):].any()
                       for row, s in enumerate(streams))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.out_spikes, w.out_spikes)
            for a, b in zip(g.stats, w.stats):
                assert_stats_equal(a, b)
            for a, b in zip(g.util + g.overflow, w.util + w.overflow):
                np.testing.assert_array_equal(a, b)
        assert set(record) == set(serving.TELEMETRY_KEYS)
        assert {k: record[k] for k in want_record} == want_record
        assert (record["seq"], record["ts"], record["b_pad"],
                record["t_pad"], record["n_requests"]) == \
            (seq, 0.5, 4, 8, len(streams))
        assert record["events"] > 0
