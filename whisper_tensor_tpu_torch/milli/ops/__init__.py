"""The milli ops the text recipes lower to, and their PyTorch lowerings.

Each module holds op classes (the port's copy of whisper_tensor_tpu/
milli/ops, numpy `eval` and shape inference) beside the lowerings of
their KINDs. Importing this package registers every lowering the port
has; the filled table is LOWERINGS.
"""

from .. import transforms  # noqa: F401  (QuantMatMul, PackedMatMul)
from ..registry import LOWERINGS
from .attention import AttentionMilli, RotaryMilli
from .basic import (Cast, CastLike, Constant, MatMul, SimpleBinary,
                    SimpleUnary, Where)
from .einsum import EinsumMilli
from .index import Gather, Range
from .misc import DynUpdateSliceMilli, KVWriteMilli
from .norm import LayerNormMilli, RMSNormMilli
from .shape import Reshape, Shape, Split, Squeeze, Transpose, Unsqueeze

__all__ = [
    "LOWERINGS", "AttentionMilli", "RotaryMilli", "Cast", "CastLike",
    "Constant", "EinsumMilli", "MatMul", "SimpleBinary", "SimpleUnary",
    "Where", "Gather", "Range", "DynUpdateSliceMilli", "KVWriteMilli",
    "LayerNormMilli", "RMSNormMilli", "Reshape", "Shape", "Split",
    "Squeeze", "Transpose", "Unsqueeze",
]
