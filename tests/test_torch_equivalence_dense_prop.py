"""The dense hypothesis property of the port's oracle-equivalence twin
(``tests/test_torch_equivalence_prop.py``, which holds the sweep, the conv
property and the check): the reference's ``dense_cases`` strategy with its
``max_examples``, bit-exact on both CPU routes against the reference's
numpy oracle."""

import test_equivalence_prop as ref_prop
from _hypothesis_compat import given, settings
from test_torch_equivalence_prop import check_case


@settings(max_examples=120, deadline=None)
@given(case=ref_prop.dense_cases())
def test_prop_dense_stacks(case):
    """Random dense stacks (multi-round, pruned, MEM_E-capped, compressed,
    4/8-bit mixtures), bit-exact on both routes."""
    check_case(case)
