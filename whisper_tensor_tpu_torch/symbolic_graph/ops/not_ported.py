"""The ONNX op types the port parses but does not run yet.

Four families of the JAX package wait for the port's media slice
(ROADMAP A9), whose models are their first users: the convolution
family (whisper_tensor_tpu/symbolic_graph/ops/linalg.py, extra.py and
milli/ops/conv.py), Resize and the vision ops (ops/data.py, ops/vision.py,
milli/ops/vision.py), and the recurrent and spectral ops
(ops/composite.py, ops/extra.py, milli/ops/rnn.py, milli/ops/signal.py).
A graph that holds one of them loads, so it can be inspected; lowering
or evaluating the node raises NotImplementedError naming its op type.
"""

from __future__ import annotations

from .base import Operation, register

DEFERRED_OP_TYPES = (
    # convolution family
    "Conv", "ConvTranspose", "ConvInteger", "QLinearConv", "DeformConv",
    "MaxPool", "AveragePool", "LpPool", "GlobalMaxPool", "GlobalAveragePool",
    # resampling and vision
    "Resize", "GridSample", "AffineGrid", "RoiAlign", "Col2Im",
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
            f"yet: it waits for the media slice (ROADMAP A9)")


register(*DEFERRED_OP_TYPES)(NotPorted)
