"""The oracle-equivalence contract on the port: twin of
``tests/test_equivalence_prop.py``.

For any mappable stack (dense and conv, multi-round, pruned, compressed,
mixed 2/4/8-bit, finite or unbounded MEM_E), the port's
``run_batched(..., device="cpu")`` on **both** routes (the f32 fused tile,
``packed_ops=False``, and the sign-magnitude codes, ``packed_ops=True``)
equals the reference's numpy oracle ``repro.core.accelerator.run_batch``
under the same ``max_events``, bit for bit: output spikes, every
``DispatchStats`` field, MEM_S&N utilisation, overflow and energy.  The
reference's own ``run_batched`` is not the yardstick: its dense route
cannot trace on JAX 0.9.0.

The 64 seeded cases come from ``tests/_torch_sweep.py`` (which the card's
smoke script also runs), held first to the reference's ``_sweep_cases()``;
the two hypothesis properties draw from the reference's own strategies
with its ``max_examples`` (the dense one in
``tests/test_torch_equivalence_dense_prop.py``, so that the two spread
over the suite's workers).  A falsified case fails with its JSON in the
message; it is not written into ``tests/golden/equivalence/``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import test_equivalence_prop as ref_prop
from _hypothesis_compat import given, settings
from _torch_helpers import assert_batched_equals_oracle
from _torch_sweep import build_case, map_case, sweep_cases
from repro.core.accelerator import run_batch

from repro_torch.engine import run_batched

torch.set_num_threads(1)

ROUTES = (False, True)          # packed_ops


def check_case(case: dict) -> None:
    """The port on both routes against the reference's oracle, on the
    reference's own model and raster of ``case``."""
    try:
        ref_model, ref_spikes = ref_prop.build_case(case)
        layers, spikes = build_case(case)
        np.testing.assert_array_equal(spikes, ref_spikes)
        port = map_case(case, layers)
        oracle = run_batch(ref_model, spikes, max_events=case["max_events"])
        for packed_ops in ROUTES:
            res = run_batched(port.pack(device="cpu", packed_ops=packed_ops),
                              spikes, max_events=case["max_events"])
            assert_batched_equals_oracle(res, oracle, len(layers),
                                         f"packed_ops={packed_ops}")
    except AssertionError as e:
        raise AssertionError(f"case {json.dumps(case, sort_keys=True)}: "
                             f"{e}") from e


def test_sweep_cases_equal_reference():
    """The port's copy of the sweep cannot drift from the reference's."""
    assert sweep_cases() == ref_prop._sweep_cases()


@pytest.mark.parametrize("idx", range(64))
def test_seeded_sweep(idx):
    """The 64 deterministic cases, bit-exact on both CPU routes."""
    check_case(sweep_cases()[idx])


@settings(max_examples=80, deadline=None)
@given(case=ref_prop.conv_cases())
def test_prop_conv_stacks(case):
    """Random conv/pool/dense stacks (shared-weight lowering,
    stride/padding, MEM_E-capped), bit-exact on both routes."""
    check_case(case)
