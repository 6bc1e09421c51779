"""The benchmark's arithmetic on hand-worked cases: the kernels' bytes and
operations, the order statistics, and the traffic's generators."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from perfbench import counts
from perfbench.stats import percentile_ms, spread
from perfbench.traffic import arrivals
from perfbench.traffic.dvs import class_rate_maps, spread_lengths


def test_synapse_work_by_hand():
    x = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    # 3 events x 4 bytes, 2 weight rows read (sources 0 and 2) of 4 dests
    # at 1 byte, 2 rows x 4 dests written at 4 bytes; 3 events x 4 adds
    assert counts.synapse_work(x, n_dest=4, bits=8) == (12 + 8 + 32, 12)
    # 4-bit rows: half a byte a weight
    assert counts.synapse_work(x, n_dest=4, bits=4) == (12 + 4 + 32, 12)
    assert counts.synapse_work(torch.zeros(5, 7), 3, 8) == (60, 0)


def test_lif_work_and_bound():
    assert counts.lif_work(rows=10, n=100) == 8000
    card = counts.peak("NVIDIA H100 80GB HBM3")
    assert counts.bound_s(3.35e12, 0, card) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12, card) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12, card) == pytest.approx(2.0)


def test_percentile_is_nearest_rank():
    xs = [0.001 * k for k in range(1, 101)]       # 1 ... 100 ms
    assert percentile_ms(xs, 50) == pytest.approx(50.0)
    assert percentile_ms(xs, 99) == pytest.approx(99.0)
    assert percentile_ms([0.002, 0.001], 99) == pytest.approx(2.0)


def test_spread_is_python_quartiles_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_lengths_are_spread_evenly():
    ls = spread_lengths(36, 8, 25)
    assert sorted(set(ls)) == list(range(8, 26))
    assert all(ls.count(t) == 2 for t in range(8, 26))


def test_every_seed_offers_the_same_gaps():
    a = arrivals.poisson(200.0, 5.0, seed=1)
    b = arrivals.poisson(200.0, 5.0, seed=2**31 + 3)
    assert abs(len(a) - len(b)) <= 2 and len(a) > 900
    ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
    n = min(len(ga), len(gb)) - 2
    assert np.allclose(ga[:n], gb[:n], rtol=0.05, atol=1e-5)
    assert a[0] == 0 and np.all(np.diff(a) > 0) and a[-1] < 5.0


def test_rate_maps_are_the_programs():
    from repro_torch.data.events import EventDatasetConfig, _class_rate_maps
    for cfg in (EventDatasetConfig.cifar10_dvs_like(down=1),
                EventDatasetConfig.nmnist_like()):
        data = dict(height=cfg.height, width=cfg.width,
                    num_classes=cfg.num_classes, base_rate=cfg.base_rate,
                    signal_rate=cfg.signal_rate,
                    blobs_per_class=cfg.blobs_per_class, rate_map_seed=1234)
        assert np.array_equal(class_rate_maps(data),
                              _class_rate_maps(cfg).reshape(10, -1))
