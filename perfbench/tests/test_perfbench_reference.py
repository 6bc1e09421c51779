"""The plain reference against the port on the CPU at a tiny size: the
quantized weights, the output spikes and the dispatch counters, exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import snn
from perfbench.reference import snn_mlp
from perfbench.tests.helpers import TINY
from perfbench.traffic.dvs import spread_lengths


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_matches_the_programs(bits):
    from repro_torch.core.quant import quantize_symmetric
    w = torch.randn(64, 48, generator=torch.Generator().manual_seed(bits))
    w[w.abs() < 0.5] = 0
    qt = quantize_symmetric(w.numpy(), bits=bits)
    want = qt.dequantize() * (w.numpy() != 0)
    assert np.array_equal(snn_mlp.quantize(w, bits).numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_reference_equals_the_port(bits):
    from repro_torch.engine import BucketPolicy, run_bucketed
    cfg = dict(TINY, quant_bits=[bits] * 3)
    gen = torch.Generator().manual_seed(2**31 + 5)
    system = snn.build(cfg, gen, "cpu")
    lengths = spread_lengths(32, 8, 25)
    streams, frames = snn.pool(cfg, lengths, gen, "cpu")
    got = run_bucketed(system["packed"], streams, policy=BucketPolicy(),
                       with_stats=True)
    ref = snn_mlp.forward(frames, lengths, system["weights"],
                          cfg["quant_bits"], cfg["lif"])
    ends = np.cumsum(lengths)
    for i, res in enumerate(got):
        rows = slice(ends[i] - lengths[i], ends[i])
        assert np.array_equal(res.out_spikes, ref["out"][rows].numpy())
        for li, st in enumerate(res.stats):
            assert np.array_equal(st.events, ref["events"][li][rows].numpy())
            assert np.array_equal(st.engine_ops, ref["ops"][li][rows].numpy())
    # every layer fires, so every layer's arithmetic is compared
    assert all(x.mean() > 0.02 for x in ref["inputs"][1:])
    assert ref["out"].mean() > 0.02


def test_ordered_currents_add_in_source_order():
    x = torch.tensor([[1.0, 1.0, 1.0]])
    w = torch.tensor([[1.0], [2.0**-24], [2.0**-24]])
    # left to right each tiny term rounds away; a matmul may keep them
    assert snn_mlp.ordered_currents(x, w).item() == 1.0


def test_unknown_precision_raises():
    with pytest.raises(ValueError):
        snn_mlp.forward(torch.zeros(1, 2), [1], [torch.zeros(2, 2)], [8],
                        TINY["lif"], precision="bf16")
