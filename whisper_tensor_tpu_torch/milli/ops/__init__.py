"""The milli op set and its PyTorch lowerings.

Each module holds op classes (the port's copy of whisper_tensor_tpu/
milli/ops, numpy `eval` and shape inference) beside the lowerings of
their KINDs. Importing this package registers every lowering the port
has; the filled table is LOWERINGS: every KIND of the reference, the
recurrent and spectral ops (rnn.py, signal.py, DFT in extra.py) and the
vision ops (vision.py) included.
"""

from .. import transforms  # noqa: F401  (QuantMatMul, PackedMatMul)
from ..registry import LOWERINGS
from . import extra, quant, vision  # noqa: F401  (register their lowerings)
from .attention import AttentionMilli, RotaryMilli
from .conv import (Conv, ConvBiasGrad, ConvInputGrad, ConvTransposeMilli,
                   ConvWeightGrad, Pool, Resize)
from .basic import (Cast, CastLike, ClampMin, Constant, ConstantOfShape,
                    MatMul, Pow, SimpleBinary, SimpleUnary, Where)
from .einsum import EinsumMilli
from .index import (Gather, GatherElements, GatherGrad, GatherND, Range,
                    ScatterElementsMilli, ScatterND)
from .misc import (DepthToSpaceMilli, DynUpdateSliceMilli, EyeLikeMilli,
                   KVWriteMilli, OneHotMilli, SpaceToDepthMilli, TileMilli,
                   TriluMilli)
from .norm import (BatchNormMilli, GroupNormMilli, InstanceNormMilli,
                   LayerNormMilli, RMSNormMilli)
from .random import RandomNormalLike
from .rnn import GruMilli, LstmMilli, RnnMilli
from .signal import StftMilli
from .reduce import ArgMinMax, CumSum, NonZero, Reduce, SizeOf, TopK
from .shape import (Concat, Expand, GatherShape, Pad, Reshape, Shape, Slice,
                    Split, Squeeze, SumTo, Transpose, Unsqueeze)

__all__ = [
    "LOWERINGS", "AttentionMilli", "RotaryMilli",
    "Cast", "CastLike", "ClampMin", "Constant", "ConstantOfShape", "MatMul",
    "Pow", "SimpleBinary", "SimpleUnary", "Where", "EinsumMilli",
    "Conv", "ConvBiasGrad", "ConvInputGrad", "ConvTransposeMilli",
    "ConvWeightGrad", "Pool", "Resize",
    "Gather", "GatherElements", "GatherGrad", "GatherND", "Range", "ScatterElementsMilli",
    "ScatterND", "DepthToSpaceMilli", "DynUpdateSliceMilli", "EyeLikeMilli",
    "KVWriteMilli", "OneHotMilli", "SpaceToDepthMilli", "TileMilli",
    "TriluMilli", "BatchNormMilli", "GroupNormMilli", "InstanceNormMilli",
    "LayerNormMilli", "RMSNormMilli", "RandomNormalLike",
    "GruMilli", "LstmMilli", "RnnMilli", "StftMilli",
    "ArgMinMax", "CumSum", "NonZero", "Reduce", "SizeOf", "TopK",
    "Concat", "Expand", "GatherShape", "Pad", "Reshape", "Shape", "Slice",
    "Split", "Squeeze", "SumTo", "Transpose", "Unsqueeze",
]
