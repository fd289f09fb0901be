"""The ONNX op types the port parses but does not run yet.

Two families of the JAX package wait for the port's later media slices
(ROADMAP A9), whose models are their first users: the vision ops
(whisper_tensor_tpu/symbolic_graph/ops/vision.py, milli/ops/vision.py;
DeformConv's lowering lives there too) and the recurrent and spectral
ops (ops/composite.py, ops/extra.py, milli/ops/rnn.py,
milli/ops/signal.py). The convolution family and Resize are ported
(milli/ops/conv.py).
A graph that holds one of them loads, so it can be inspected; lowering
or evaluating the node raises NotImplementedError naming its op type.
"""

from __future__ import annotations

from .base import Operation, register

DEFERRED_OP_TYPES = (
    # vision
    "DeformConv", "GridSample", "AffineGrid", "RoiAlign", "Col2Im",
    "CenterCropPad", "NonMaxSuppression", "ImageDecoder",
    # recurrent and spectral
    "LSTM", "GRU", "RNN", "DFT", "STFT",
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
