"""The ONNX op types the port parses but does not run yet.

One family of the JAX package waits for a later media slice (ROADMAP
A9.1): the vision ops (whisper_tensor_tpu/symbolic_graph/ops/vision.py,
milli/ops/vision.py; DeformConv's lowering lives there too). The
convolution family and Resize (milli/ops/conv.py) and the recurrent and
spectral ops (milli/ops/rnn.py, milli/ops/signal.py, DFT in
milli/ops/extra.py) are ported.
A graph that holds one of them loads, so it can be inspected; lowering
or evaluating the node raises NotImplementedError naming its op type.
"""

from __future__ import annotations

from .base import Operation, register

DEFERRED_OP_TYPES = (
    # vision
    "DeformConv", "GridSample", "AffineGrid", "RoiAlign", "Col2Im",
    "CenterCropPad", "NonMaxSuppression", "ImageDecoder",
)


class NotPorted(Operation):
    """A node of a deferred op type: raises when it is lowered."""

    def __init__(self, op_type: str = "?"):
        self.OP_TYPE = op_type

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(node.op_type)

    def lower(self, ctx, inputs, n_outputs):
        raise NotImplementedError(
            f"ONNX op {self.OP_TYPE} is not ported to the PyTorch package "
            f"yet: it waits for a later media slice (ROADMAP A9)")


register(*DEFERRED_OP_TYPES)(NotPorted)
