"""The conformance corpus through the PyTorch port on the CPU: the reference-list modules (reduce, misc, final, last) and the sequence module
of tests/conformance/.

Each case is built with the port's OnnxBuilder, run through the port's
`Model.eval(..., device="cpu")` and held to the case's independent
oracle at its own tolerances (rtol 1e-3 / atol 1e-7 unless the case sets
others; integers and strings exact), as tests/conformance/harness.py's
`check_case` holds the JAX package.
"""

import pytest

import torch_conformance as tc

CASES = tc.selected(tc.cases_of("cases_ref_reduce", "cases_ref_misc", "cases_ref_final", "cases_ref_last", "cases_sequence"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_corpus_case_through_the_port(case):
    tc.check_port_case(case)
