"""The milli op set and its PyTorch lowerings.

Each module holds op classes (the port's copy of whisper_tensor_tpu/
milli/ops, numpy `eval` and shape inference) beside the lowerings of
their KINDs. Importing this package registers every lowering the port
has; the filled table is LOWERINGS. The convolution, resampling, vision,
recurrent and spectral ops (the reference's conv.py, vision.py, rnn.py,
signal.py) are not ported yet (symbolic_graph/ops/not_ported.py).
"""

from .. import transforms  # noqa: F401  (QuantMatMul, PackedMatMul)
from ..registry import LOWERINGS
from . import extra, quant  # noqa: F401  (register their lowerings)
from .attention import AttentionMilli, RotaryMilli
from .basic import (Cast, CastLike, ClampMin, Constant, ConstantOfShape,
                    MatMul, Pow, SimpleBinary, SimpleUnary, Where)
from .einsum import EinsumMilli
from .index import (Gather, GatherElements, GatherND, Range,
                    ScatterElementsMilli, ScatterND)
from .misc import (DepthToSpaceMilli, DynUpdateSliceMilli, EyeLikeMilli,
                   KVWriteMilli, OneHotMilli, SpaceToDepthMilli, TileMilli,
                   TriluMilli)
from .norm import (BatchNormMilli, GroupNormMilli, InstanceNormMilli,
                   LayerNormMilli, RMSNormMilli)
from .random import RandomNormalLike
from .reduce import ArgMinMax, CumSum, NonZero, Reduce, SizeOf, TopK
from .shape import (Concat, Expand, GatherShape, Pad, Reshape, Shape, Slice,
                    Split, Squeeze, Transpose, Unsqueeze)

__all__ = [
    "LOWERINGS", "AttentionMilli", "RotaryMilli",
    "Cast", "CastLike", "ClampMin", "Constant", "ConstantOfShape", "MatMul",
    "Pow", "SimpleBinary", "SimpleUnary", "Where", "EinsumMilli",
    "Gather", "GatherElements", "GatherND", "Range", "ScatterElementsMilli",
    "ScatterND", "DepthToSpaceMilli", "DynUpdateSliceMilli", "EyeLikeMilli",
    "KVWriteMilli", "OneHotMilli", "SpaceToDepthMilli", "TileMilli",
    "TriluMilli", "BatchNormMilli", "GroupNormMilli", "InstanceNormMilli",
    "LayerNormMilli", "RMSNormMilli", "RandomNormalLike",
    "ArgMinMax", "CumSum", "NonZero", "Reduce", "SizeOf", "TopK",
    "Concat", "Expand", "GatherShape", "Pad", "Reshape", "Shape", "Slice",
    "Split", "Squeeze", "Transpose", "Unsqueeze",
]
