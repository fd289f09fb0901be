"""Built-in loss constructors appended to a MilliOpGraph.

Reference equivalent: cross_entropy_loss / mse_loss / l1_loss
(src/milli_graph/mod.rs:727-835). Each takes the graph + prediction
tensor id (+ target input) and returns the scalar loss tensor id,
tagged Phase.LOSS.

The port's copy of whisper_tensor_tpu/milli/losses.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .ir import MilliGraph, Phase
from .ops import (Cast, CastLike, Constant, Gather, GatherElements, Reduce,
                  Reshape, Shape, SimpleBinary, SimpleUnary, Unsqueeze)
from ..dtype import DType

P = Phase.LOSS


def mse_loss(g: MilliGraph, pred: int, target: int) -> int:
    d = g.op1(SimpleBinary("sub"), pred, target, phase=P)
    sq = g.op1(SimpleBinary("mul"), d, d, phase=P)
    return g.op1(Reduce("mean", None, keepdims=False), sq, phase=P)


def l1_loss(g: MilliGraph, pred: int, target: int) -> int:
    d = g.op1(SimpleUnary("abs"),
              g.op1(SimpleBinary("sub"), pred, target, phase=P), phase=P)
    return g.op1(Reduce("mean", None, keepdims=False), d, phase=P)


def cross_entropy_loss(g: MilliGraph, logits: int, target_ids: int) -> int:
    """logits (..., V) float; target_ids (...) int64 -> scalar mean NLL.
    Numerically-stable log-softmax built from milli primitives."""
    mx = g.op1(Reduce("max", axes=[-1], keepdims=True), logits, phase=P)
    sh = g.op1(SimpleBinary("sub"), logits, mx, phase=P)
    ex = g.op1(SimpleUnary("exp"), sh, phase=P)
    s = g.op1(Reduce("sum", axes=[-1], keepdims=True), ex, phase=P)
    logp = g.op1(SimpleBinary("sub"), sh,
                 g.op1(SimpleUnary("log"), s, phase=P), phase=P)
    idx = g.op1(Unsqueeze(axes=[-1]), target_ids, phase=P)
    picked = g.op1(GatherElements(axis=-1), logp, idx, phase=P)
    nll = g.op1(SimpleUnary("neg"), picked, phase=P)
    return g.op1(Reduce("mean", None, keepdims=False), nll, phase=P)
