"""The ONNX-level IR: SymbolicGraph, its TensorStore, and the symbolic
ops the text recipes emit (the port's copy of
whisper_tensor_tpu/symbolic_graph/, trimmed to those ops)."""

from .ir import SOp, STensor, SymbolicGraph, TensorKind, UnsupportedOnnxOp
from .tensor_store import TensorStore

# op registration side effects
from .ops import composite as _composite  # noqa: F401
from .ops import data as _data  # noqa: F401
from .ops import elementwise as _elementwise  # noqa: F401
from .ops import linalg as _linalg  # noqa: F401
from .ops import norm as _norm  # noqa: F401

__all__ = ["SymbolicGraph", "STensor", "SOp", "TensorKind",
           "UnsupportedOnnxOp", "TensorStore"]
