"""The control on the card: the reference computed with TF32 currents, one
precision below the configuration's float32, judged by a run's comparison,
comes out not correct.  Needs a CUDA card; skips without one."""

from __future__ import annotations

import pytest
import torch

from perfbench import control


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_comes_out_not_correct(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = control.readings("nmnist_mlp4.batch_nostats", seed,
                           device="cuda")
    assert any(v > lim for v, lim in out["checks"].values()), out


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_on_the_card_matches_the_programs(bits):
    """On the card the reference's scale is a true division, as numpy's,
    for weights whose largest magnitude over 2**(bits-1) - 1 rounds
    otherwise than its product with the rounded reciprocal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from perfbench.reference import snn_mlp
    from repro_torch.core.quant import quantize_symmetric
    gen = torch.Generator("cuda").manual_seed(bits)
    for _ in range(64):
        w = torch.randn(200, 100, generator=gen, device="cuda")
        qt = quantize_symmetric(w.cpu().numpy(), bits=bits)
        want = qt.dequantize() * (w.cpu().numpy() != 0)
        assert np.array_equal(snn_mlp.quantize(w, bits).cpu().numpy(), want)
