"""The conformance corpus through the PyTorch port on the CPU: the elementwise, shape, nn, dtype, reduction, pool, misc2 and more modules
of tests/conformance/.

Each case is built with the port's OnnxBuilder, run through the port's
`Model.eval(..., device="cpu")` and held to the case's independent
oracle at its own tolerances (rtol 1e-3 / atol 1e-7 unless the case sets
others; integers and strings exact), as tests/conformance/harness.py's
`check_case` holds the JAX package.
"""

import numpy as np
import pytest

import torch_conformance as tc

CASES = tc.selected(tc.cases_of("cases_elementwise", "cases_shape", "cases_nn", "cases_dtypes", "cases_reduce2", "cases_pool", "cases_misc2", "cases_more"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_corpus_case_through_the_port(case):
    tc.check_port_case(case)


# -- each lowered kind's numpy eval against the reference's ---------------
# The kinds the text recipes emit are held op by op in
# tests/test_torch_port_frontend.py; every other kind the port lowers is
# held here on the corpus graphs that hold it: the port's interpreter
# (its numpy copies of the ops) gives the JAX package's interpreter's
# bytes on the same ONNX and feeds.

from test_torch_port_frontend import RECIPE_KINDS  # noqa: E402
from whisper_tensor_tpu.model import Model as JaxModel  # noqa: E402
from whisper_tensor_tpu_torch.milli.ops import LOWERINGS  # noqa: E402

# RandomNormalLike draws from torch's generator: it matches the oracle in
# distribution (test_torch_conformance_control.py), not value for value.
# The gradient kinds appear in no ONNX graph: only build_training_graph
# emits them (test_torch_port_milli_training.py holds their lowerings)
TRAINING_KINDS = {"GatherGrad", "SumTo", "ConvInputGrad", "ConvWeightGrad",
                  "ConvBiasGrad"}
OTHER_KINDS = sorted(set(LOWERINGS) - set(RECIPE_KINDS)
                     - {"KVWrite", "RandomNormalLike"} - TRAINING_KINDS)


def _cases_by_kind(per_kind=3):
    by_kind = {}
    for case in tc.selected(tc.cases_of(*tc.MODULES)):
        graph = tc.port_model(case).graph
        if graph.has_control_flow() or graph.needs_host_eval():
            continue
        for kind in {n.op.KIND for n in graph.to_milli()[0].nodes}:
            if len(by_kind.setdefault(kind, [])) < per_kind:
                by_kind[kind].append(case)
    return by_kind


@pytest.fixture(scope="module")
def cases_by_kind():
    return _cases_by_kind()


@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_milli_op_eval_matches_the_reference_on_the_corpus(kind,
                                                           cases_by_kind):
    cases = cases_by_kind.get(kind)
    assert cases, f"no corpus graph holds a {kind} node"
    for case in cases:
        data = tc.onnx_bytes(case)
        feeds = tc.feeds_of(case)
        want = JaxModel.new_from_onnx(data).eval(dict(feeds), mode="oracle")
        got = tc.Model.new_from_onnx(data).eval(dict(feeds), mode="oracle")
        for name, w in want.items():
            g, w = np.asarray(got[name]), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, case.name
            assert g.tobytes() == w.tobytes(), case.name
