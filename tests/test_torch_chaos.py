"""The port's chaos scenarios against the reference's, twin for twin with
the non-socket tests of tests/test_chaos.py.  Arrival traces are numpy
only and must equal the reference's exactly; every scenario the reference
can run on its packed route replays on both fabrics with equal metrics and
bit-equal outputs; scenarios that script device loss need a mesh of at
least 2 devices and are refused without one, recover onto the shrunken
mesh with one (a spoofed 2-way mesh of the CPU here; the reference's
sharded path does not run on the installed JAX, so the recovered runs are
held to the port's single-device engine), and a device loss with no mesh
is fatal."""

import numpy as np
import pytest
import torch

from _torch_helpers import demo_models
from repro.engine import chaos as ref_chaos

from repro_torch.core.noise import AnalogNoise, as_noise_key, perturb_packed
from repro_torch.engine import (ARRIVAL_MODES, SCENARIOS, BucketPolicy,
                                ChaosScenario, DeviceLossError, StreamServer,
                                VirtualClock, make_chaos_hook, run_batched,
                                run_scenario, shrink_mesh, snn_serve_mesh,
                                synth_arrival_trace)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return demo_models("mlp")


def _nonmesh():
    return [s for s in SCENARIOS.values() if not s.needs_mesh]


def _reference_runs(sc) -> bool:
    """Whether the reference can replay ``sc`` on its packed route: serving
    noise and the perturbed swap payload need its f32 (dense) route."""
    return not (sc.noise_sigma or sc.tenants)


# ---------------------------------------------------------- arrival synth

@pytest.mark.parametrize("mode", ARRIVAL_MODES)
def test_arrival_traces_equal_the_reference(mode):
    assert ARRIVAL_MODES == ref_chaos.ARRIVAL_MODES
    got = synth_arrival_trace(20, 14, mode=mode, seed=3)
    want = ref_chaos.synth_arrival_trace(20, 14, mode=mode, seed=3)
    assert len(got) == 20
    assert [t for t, _, _ in got] == sorted(t for t, _, _ in got)
    for (t, s, d), (rt, rs, rd) in zip(got, want):
        assert (t, d) == (rt, rd) and d > t
        np.testing.assert_array_equal(s, rs)


def test_adversarial_trace_mixes_tight_and_loose_deadlines():
    trace = synth_arrival_trace(24, 14, mode="adversarial", slack=0.4,
                                t_lo=3, t_hi=12, seed=0)
    assert {round(d - t, 6) for t, _, d in trace} == {0.1, 0.4}
    assert {s.shape[0] for _, s, _ in trace} == {3, 12}


def test_unknown_arrival_mode_rejected():
    with pytest.raises(ValueError, match="unknown arrival mode"):
        synth_arrival_trace(4, 14, mode="lunar")


def test_chaos_hook_fires_once_per_scripted_ordinal():
    hook = make_chaos_hook([(2, 1)])
    hook(0)
    hook(1)
    with pytest.raises(DeviceLossError) as ei:
        hook(2)
    assert ei.value.n_lost == 1
    hook(2)


def test_scenario_table_equals_the_reference():
    assert list(SCENARIOS) == list(ref_chaos.SCENARIOS)
    for name, sc in SCENARIOS.items():
        ref = ref_chaos.SCENARIOS[name]
        assert sc.needs_mesh == ref.needs_mesh
        for f in ("arrivals", "n_requests", "rate", "slack", "t_lo", "t_hi",
                  "noise_sigma", "noise_probe_every", "lose_devices",
                  "backpressure", "overlong", "queue_capacity", "service_s",
                  "seed", "swap_tenant", "swap_at", "swap_sigma"):
            assert getattr(sc, f) == getattr(ref, f), (name, f)


# ----------------------------------------------- deterministic replays

@pytest.mark.parametrize("name", [s.name for s in SCENARIOS.values()
                                  if not s.needs_mesh])
def test_scenario_replays_deterministically_and_twins(models, name):
    """Two replays on the port: identical metrics and outputs.  Where the
    reference runs the scenario, its metrics and every output are equal
    too."""
    sc = SCENARIOS[name]
    r1, rids1, m1 = run_scenario(models[1], sc)
    r2, rids2, m2 = run_scenario(models[1], sc)
    assert m1 == m2 and rids1 == rids2 and r1.keys() == r2.keys()
    for rid in r1:
        assert np.array_equal(r1[rid].out_spikes, r2[rid].out_spikes)
    assert m1["completed"] + m1["rejected"] + m1["shed"] == m1["submitted"]
    assert m1["scenario"] == name and m1["makespan_s"] > 0.0
    if _reference_runs(sc):
        rr, rrids, rm = ref_chaos.run_scenario(models[0],
                                               ref_chaos.SCENARIOS[name])
        assert m1 == rm and rids1 == rrids
        for rid in r1:
            np.testing.assert_array_equal(r1[rid].out_spikes,
                                          np.asarray(rr[rid].out_spikes))


def test_baseline_scenario_is_bit_exact_vs_run_batched(models):
    packed = models[1]
    sc = SCENARIOS["baseline"]
    results, rids, _ = run_scenario(packed, sc)
    trace = synth_arrival_trace(sc.n_requests, packed.n_in, mode=sc.arrivals,
                                rate=sc.rate, slack=sc.slack, t_lo=sc.t_lo,
                                t_hi=sc.t_hi, seed=sc.seed)
    i = int(np.argmax([s.shape[0] for _, s, _ in trace]))
    alone = run_batched(packed, trace[i][1][None], with_stats=False)
    assert np.array_equal(results[rids[i]].out_spikes, alone.out_spikes[0])


def test_analog_noise_scenario_tracks_agreement(models):
    """Every dispatch probed, agreement in [0, 1], some output changed by
    the noise; and noise changes no scheduling decision, so the dispatch
    sequence is the reference's noiseless baseline's."""
    packed = models[1]
    _, _, m = run_scenario(packed, SCENARIOS["analog_noise"])
    assert m["noise_probes"] == m["completed"] > 0
    assert 0.0 <= m["noise_agreement"] <= 1.0
    clean, _, _ = run_scenario(packed, SCENARIOS["baseline"])
    noisy, _, _ = run_scenario(packed, ChaosScenario(
        name="noise-vs-clean", description="", noise_sigma=0.05))
    assert any(not np.array_equal(clean[r].out_spikes, noisy[r].out_spikes)
               for r in clean)
    _, _, want = ref_chaos.run_scenario(models[0],
                                        ref_chaos.SCENARIOS["baseline"])
    for k in ("dispatches", "forced_dispatches", "completed",
              "bucket_fill_ratio", "p50_latency_s", "p99_latency_s",
              "makespan_s"):
        assert m[k] == want[k], k


def test_slo_scenario_flips_to_shedding(models):
    _, _, m = run_scenario(models[1], SCENARIOS["slo_shed"])
    assert m["slo_switches"] >= 1 and m["shed"] + m["rejected"] > 0
    assert m["deadline_miss_rate"] > SCENARIOS["slo_shed"].slo.target_miss_rate


# ------------------------------------------------ device loss (one device)

@pytest.mark.parametrize("name", ["device_loss", "blackout"])
def test_device_loss_scenarios_need_a_mesh(models, name):
    """The reference refuses these without a >= 2-device mesh; the port
    serves on one device and refuses them with the reason."""
    assert SCENARIOS[name].needs_mesh
    with pytest.raises(ValueError, match="device loss"):
        run_scenario(models[1], SCENARIOS[name])


def test_device_loss_is_fatal_on_one_device(models):
    """With no mesh to shrink onto, a DeviceLossError at a dispatch
    propagates, as the reference's single-device server re-raises it."""
    server = StreamServer(models[1], clock=VirtualClock(),
                          policy=BucketPolicy(batch_sizes=(2,),
                                              time_steps=(8,)),
                          chaos_hook=make_chaos_hook([(1, 1)]))
    stream = np.zeros((4, 64), np.float32)
    server.submit(stream)
    server.submit(stream)                       # dispatch 0 runs
    server.submit(stream)
    with pytest.raises(DeviceLossError):
        server.submit(stream)                   # dispatch 1 loses a device
    assert server.metrics.snapshot()["device_losses"] == 0


# ------------------------------------------------ device loss on a mesh

def test_device_loss_scenarios_recover_on_shrunken_mesh(models):
    """device_loss and blackout on a spoofed 2-way mesh: the scripted loss
    fires, the server recovers onto 1 device, every admitted request is
    still served, both replays are deterministic, and every completed
    request equals the single-device engine's run of it alone (through the
    scenario's noisy device instance where it serves one)."""
    packed = models[1]
    mesh = snn_serve_mesh(device="cpu", spoof=2)
    for name in ("device_loss", "blackout"):
        sc = SCENARIOS[name]
        r1, rids, m1 = run_scenario(packed, sc, mesh=mesh)
        r2, _, m2 = run_scenario(packed, sc, mesh=mesh)
        assert m1 == m2, f"{name}: not deterministic"
        assert r1.keys() == r2.keys() and all(
            np.array_equal(r1[k].out_spikes, r2[k].out_spikes) for k in r1)
        assert m1["device_losses"] == len(sc.lose_devices), name
        assert (m1["mesh_size_start"], m1["mesh_size_end"]) == (2, 1), name
        assert m1["served_all_admitted"], f"{name}: lost admitted requests"
        served = (perturb_packed(as_noise_key(sc.seed), packed,
                                 AnalogNoise(weight_sigma=sc.noise_sigma))
                  if sc.noise_sigma > 0 else packed)
        trace = synth_arrival_trace(
            sc.n_requests, packed.n_in, mode=sc.arrivals, rate=sc.rate,
            slack=sc.slack, t_lo=sc.t_lo, t_hi=sc.t_hi, seed=sc.seed)
        done = [(rid, s) for rid, (_, s, _) in zip(rids, trace)
                if rid is not None and rid in r1]
        assert len(done) == m1["completed"] > 0
        for rid, s in done:
            alone = run_batched(served, s[None], with_stats=False)
            np.testing.assert_array_equal(r1[rid].out_spikes,
                                          alone.out_spikes[0],
                                          err_msg=f"{name} rid {rid}")


def test_losing_every_device_is_fatal():
    """Recovery needs survivors: shrinking past the last device raises
    instead of serving on nothing, and a server whose 2-way mesh loses
    both devices at one dispatch re-raises."""
    mesh = snn_serve_mesh(device="cpu", spoof=2)
    small = shrink_mesh(mesh, 1)
    assert small.size == 1 and small.axis_names == mesh.axis_names
    with pytest.raises(DeviceLossError) as e:
        shrink_mesh(small, 1)
    assert e.value.n_lost == 1


def test_losing_every_device_mid_serving_is_fatal(models):
    server = StreamServer(models[1], clock=VirtualClock(),
                          mesh=snn_serve_mesh(device="cpu", spoof=2),
                          policy=BucketPolicy(batch_sizes=(2,),
                                              time_steps=(8,)),
                          chaos_hook=make_chaos_hook([(0, 2)]))
    stream = np.zeros((4, 64), np.float32)
    server.submit(stream)
    with pytest.raises(DeviceLossError, match="all 2 devices lost"):
        server.submit(stream)                   # dispatch 0 loses both
    assert server.metrics.snapshot()["device_losses"] == 0


def test_serve_snn_runs_device_loss_on_a_spoofed_mesh():
    """`python -m repro_torch.launch.serve_snn --scenario all --smoke
    --device cpu --spoof-devices 2` runs every scenario, device loss
    included, and names the mesh; without a mesh those two are skipped,
    and `--data 2` with one device raises with the reason."""
    import contextlib
    import io

    from repro_torch.launch.serve_snn import main

    def run(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(["--smoke", "--device", "cpu", *argv])
        return out.getvalue().splitlines()

    lines = run("--scenario", "all", "--spoof-devices", "2")
    assert len(lines) == len(SCENARIOS)
    for name in ("device_loss", "blackout"):
        line = next(x for x in lines if x.startswith(f"chaos/mlp/{name}:"))
        assert "mesh 2->1" in line and "SKIP" not in line
    lines = run("--scenario", "device_loss")
    assert "SKIP" in lines[0]
    lines = run("--spoof-devices", "2")
    assert lines[0].startswith("serve/mlp:") and "2-way mesh" in lines[0]
    with pytest.raises(ValueError, match="2-way mesh, but 1 cpu"):
        run("--data", "2")
