"""The ONNX-level IR: SymbolicGraph, its TensorStore, and the symbolic
ops (the port's copy of whisper_tensor_tpu/symbolic_graph/: every ONNX
op type of the reference, ONNX re-export and surgery)."""

from .ir import SOp, STensor, SymbolicGraph, TensorKind, UnsupportedOnnxOp
from .tensor_store import TensorStore

# op registration side effects
from .ops import composite as _composite  # noqa: F401
from .ops import control as _control  # noqa: F401
from .ops import data as _data  # noqa: F401
from .ops import elementwise as _elementwise  # noqa: F401
from .ops import extra as _extra  # noqa: F401
from .ops import linalg as _linalg  # noqa: F401
from .ops import norm as _norm  # noqa: F401
from .ops import reduce as _reduce  # noqa: F401
from .ops import sequence as _sequence  # noqa: F401
from .ops import vision as _vision  # noqa: F401

__all__ = ["SymbolicGraph", "STensor", "SOp", "TensorKind",
           "UnsupportedOnnxOp", "TensorStore"]
