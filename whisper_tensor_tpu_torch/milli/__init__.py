"""The milli IR (the port's copy of whisper_tensor_tpu/milli/ir.py)
and, in milli/ops, its op classes with their PyTorch lowerings."""

from .ir import (EvalCancelled, MilliGraph, MilliNode, MilliObserver,
                 MilliOp, Phase)

__all__ = ["MilliGraph", "MilliNode", "MilliOp", "MilliObserver", "Phase",
           "EvalCancelled"]
