"""Normalization + softmax symbolic ops.

Reference equivalents: src/symbolic_graph/ops/normalization.rs
(LayerNormalization, RMSNormalization, GroupNormalization,
InstanceNormalization, LpNormalization) and softmax lowering. All lower
to milli primitives; on TPU, XLA fuses these chains into single kernels
(the Pallas fused-norm kernels serve the recipe fast-path instead).

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/norm.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ...dtype import DType
from ...milli.ops import (Cast, CastLike, ClampMin, Gather, GatherElements,
                          Reduce, SimpleBinary, SimpleUnary, Squeeze,
                          Unsqueeze, Where)
from .base import Operation, register


def _softmax(ctx, x, axis):
    mx = ctx.emit1(Reduce("max", axes=[axis], keepdims=True), x)
    sh = ctx.emit1(SimpleBinary("sub"), x, mx)
    ex = ctx.emit1(SimpleUnary("exp"), sh)
    s = ctx.emit1(Reduce("sum", axes=[axis], keepdims=True), ex)
    return ctx.emit1(SimpleBinary("div"), ex, s), sh, s


@register("Softmax")
@dataclass
class Softmax(Operation):
    axis: int = -1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        # opset <13 default axis=1; >=13 default -1
        return cls(attrs.i("axis", -1 if opset >= 13 else 1))

    def lower(self, ctx, inputs, n_outputs):
        y, _, _ = _softmax(ctx, inputs[0], self.axis)
        return [y]


@register("LogSoftmax")
@dataclass
class LogSoftmax(Operation):
    axis: int = -1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1 if opset >= 13 else 1))

    def lower(self, ctx, inputs, n_outputs):
        _, sh, s = _softmax(ctx, inputs[0], self.axis)
        return [ctx.emit1(SimpleBinary("sub"), sh, ctx.emit1(SimpleUnary("log"), s))]


@register("Softmax1")
@dataclass
class Softmax1(Operation):
    """Quiet softmax (custom `wt` domain): exp(x)/(1 + sum(exp(x))) —
    the "+1" lets a row attend to nothing (attention-sink variant).
    Stable form: with m = max(x, 0-included): exp(x-m)/(exp(-m) +
    sum(exp(x-m)))."""

    axis: int = -1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        mx0 = ctx.emit1(Reduce("max", axes=[self.axis], keepdims=True), x)
        mx = ctx.emit1(ClampMin(0.0), mx0)  # include the implicit 0 logit
        sh = ctx.emit1(SimpleBinary("sub"), x, mx)
        ex = ctx.emit1(SimpleUnary("exp"), sh)
        s = ctx.emit1(Reduce("sum", axes=[self.axis], keepdims=True), ex)
        one_term = ctx.emit1(SimpleUnary("exp"),
                             ctx.emit1(SimpleUnary("neg"), mx))
        denom = ctx.emit1(SimpleBinary("add"), s, one_term)
        return [ctx.emit1(SimpleBinary("div"), ex, denom)]


def _mean_var_normalize(ctx, x, axes, eps, compute_in_f32=True):
    """(x - mean)/sqrt(var + eps) over `axes` (biased variance, ONNX)."""
    xc = ctx.emit1(Cast(DType.F32), x) if compute_in_f32 else x
    mean = ctx.emit1(Reduce("mean", axes=axes, keepdims=True), xc)
    diff = ctx.emit1(SimpleBinary("sub"), xc, mean)
    var = ctx.emit1(Reduce("mean", axes=axes, keepdims=True),
                    ctx.emit1(SimpleBinary("mul"), diff, diff))
    veps = ctx.emit1(SimpleBinary("add"), var, ctx.const_like(eps, var))
    inv = ctx.emit1(SimpleUnary("sqrt"), veps)
    norm = ctx.emit1(SimpleBinary("div"), diff, inv)
    if compute_in_f32:
        norm = ctx.emit1(CastLike(), norm, x)
        mean = ctx.emit1(CastLike(), mean, x)
        inv = ctx.emit1(CastLike(), inv, x)
    return norm, mean, inv


@register("LayerNormalization")
@dataclass
class LayerNormalization(Operation):
    axis: int = -1
    epsilon: float = 1e-5
    stash_type: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), attrs.f("epsilon", 1e-5),
                   attrs.i("stash_type", 1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.norm import LayerNormMilli

        args = [i for i in inputs if i is not None]
        return ctx.emit(LayerNormMilli(self.axis, self.epsilon,
                                       bool(self.stash_type),
                                       n_out=n_outputs),
                        *args, n_outputs=n_outputs)


@register("RMSNormalization")
@dataclass
class RMSNormalization(Operation):
    axis: int = -1
    epsilon: float = 1e-5
    stash_type: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), attrs.f("epsilon", 1e-5),
                   attrs.i("stash_type", 1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.norm import RMSNormMilli

        return [ctx.emit1(RMSNormMilli(self.axis, self.epsilon,
                                       bool(self.stash_type)), inputs[0], inputs[1])]


@register("InstanceNormalization")
@dataclass
class InstanceNormalization(Operation):
    epsilon: float = 1e-5
    spatial_rank: Optional[int] = None  # optional hint from importer

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("epsilon", 1e-5))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.norm import InstanceNormMilli

        x, scale, bias = inputs[0], inputs[1], inputs[2]
        return [ctx.emit1(InstanceNormMilli(self.epsilon), x, scale, bias)]


@register("GroupNormalization")
@dataclass
class GroupNormalization(Operation):
    epsilon: float = 1e-5
    num_groups: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("epsilon", 1e-5), attrs.i("num_groups", 1))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.norm import GroupNormMilli

        x, scale, bias = inputs[0], inputs[1], inputs[2]
        return [ctx.emit1(GroupNormMilli(self.epsilon, self.num_groups), x, scale, bias)]


@register("BatchNormalization")
@dataclass
class BatchNormalization(Operation):
    epsilon: float = 1e-5
    momentum: float = 0.9
    training_mode: bool = False

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.f("epsilon", 1e-5), attrs.f("momentum", 0.9),
                   bool(attrs.i("training_mode", 0)))

    def lower(self, ctx, inputs, n_outputs):
        from ...milli.ops.norm import BatchNormMilli

        x, scale, bias, mean, var = inputs[:5]
        return ctx.emit(BatchNormMilli(self.epsilon, self.training_mode,
                                       self.momentum, n_out=n_outputs),
                        x, scale, bias, mean, var, n_outputs=n_outputs)


@register("LpNormalization")
@dataclass
class LpNormalization(Operation):
    axis: int = -1
    p: int = 2

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", -1), attrs.i("p", 2))

    def lower(self, ctx, inputs, n_outputs):
        x = inputs[0]
        mode = "l2" if self.p == 2 else "l1"
        n = ctx.emit1(Reduce(mode, axes=[self.axis], keepdims=True), x)
        return [ctx.emit1(SimpleBinary("div"), x, n)]


@register("MeanVarianceNormalization")
@dataclass
class MeanVarianceNormalization(Operation):
    axes: List[int] = None  # type: ignore[assignment]

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.ints("axes", [0, 2, 3]))

    def lower(self, ctx, inputs, n_outputs):
        norm, _, _ = _mean_var_normalize(ctx, inputs[0], self.axes, 1e-9,
                                         compute_in_f32=False)
        return [norm]


def _pick_class(ctx, logp, labels):
    """logp (N,C,d1..dk), labels int (N,d1..dk) -> logp at the label
    class, shape (N,d1..dk) (GatherElements along the class axis)."""
    lbl_u = ctx.emit1(Unsqueeze(axes=[1]), labels)
    picked = ctx.emit1(GatherElements(axis=1), logp, lbl_u)
    return ctx.emit1(Squeeze(axes=[1]), picked)


def _nll_reduce(ctx, pick_neg, labels, weights, reduction, ignore_index):
    """Shared NLL tail: per-element loss `pick_neg` (N,d1..dk) already
    negated; applies class weights / ignore_index masking and the
    reduction. ONNX 'mean' is the WEIGHTED mean sum(l*w)/sum(w)."""
    w = None
    if weights is not None:
        safe = labels
        if ignore_index is not None:
            ii = ctx.emit1(CastLike(), ctx.const(
                np.asarray(ignore_index, np.int64)), labels)
            ign = ctx.emit1(SimpleBinary("eq"), labels, ii)
            zero = ctx.emit1(CastLike(), ctx.const(
                np.asarray(0, np.int64)), labels)
            safe = ctx.emit1(Where(), ign, zero, labels)
        w = ctx.emit1(Gather(axis=0), weights, safe)
    if ignore_index is not None:
        ii = ctx.emit1(CastLike(), ctx.const(
            np.asarray(ignore_index, np.int64)), labels)
        keep = ctx.emit1(SimpleBinary("ne"), labels, ii)
        keep_f = ctx.emit1(CastLike(), keep, pick_neg)
        w = keep_f if w is None else ctx.emit1(SimpleBinary("mul"), w, keep_f)
    loss = pick_neg if w is None else ctx.emit1(SimpleBinary("mul"),
                                                pick_neg, w)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return ctx.emit1(Reduce("sum", axes=None, keepdims=False), loss)
    # mean: weighted by the per-element weights when any exist
    if w is None:
        return ctx.emit1(Reduce("mean", axes=None, keepdims=False), loss)
    num = ctx.emit1(Reduce("sum", axes=None, keepdims=False), loss)
    den = ctx.emit1(Reduce("sum", axes=None, keepdims=False), w)
    return ctx.emit1(SimpleBinary("div"), num, den)


@register("SoftmaxCrossEntropyLoss")
@dataclass
class SoftmaxCrossEntropyLoss(Operation):
    """loss [, log_prob] = NLL(LogSoftmax(scores, axis=1), labels).

    Reference runs this family from the official corpus
    (tests/onnx_testing.rs test_sce_*); here lowered to milli
    primitives (log-softmax + GatherElements + masked reduction)."""

    reduction: str = "mean"
    ignore_index: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        ii = attrs.i("ignore_index", None)
        return cls(attrs.s("reduction", "mean"),
                   int(ii) if ii is not None else None)

    def lower(self, ctx, inputs, n_outputs):
        scores, labels = inputs[0], inputs[1]
        weights = inputs[2] if len(inputs) > 2 else None
        _, sh, s = _softmax(ctx, scores, 1)
        logp = ctx.emit1(SimpleBinary("sub"), sh,
                         ctx.emit1(SimpleUnary("log"), s))
        safe = labels
        if self.ignore_index is not None:
            # ignored labels may be out of class range: clamp for gather
            ii = ctx.emit1(CastLike(), ctx.const(
                np.asarray(self.ignore_index, np.int64)), labels)
            ign = ctx.emit1(SimpleBinary("eq"), labels, ii)
            zero = ctx.emit1(CastLike(), ctx.const(
                np.asarray(0, np.int64)), labels)
            safe = ctx.emit1(Where(), ign, zero, labels)
        pick = _pick_class(ctx, logp, safe)
        neg = ctx.emit1(SimpleUnary("neg"), pick)
        loss = _nll_reduce(ctx, neg, labels, weights, self.reduction,
                           self.ignore_index)
        return [loss, logp][:n_outputs]


@register("NegativeLogLikelihoodLoss")
@dataclass
class NegativeLogLikelihoodLoss(Operation):
    """loss = -input[n, labels[n], d...] with weights/ignore_index and
    mean/sum/none reduction (official corpus test_nllloss_*)."""

    reduction: str = "mean"
    ignore_index: Optional[int] = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        ii = attrs.i("ignore_index", None)
        return cls(attrs.s("reduction", "mean"),
                   int(ii) if ii is not None else None)

    def lower(self, ctx, inputs, n_outputs):
        x, labels = inputs[0], inputs[1]
        weights = inputs[2] if len(inputs) > 2 else None
        safe = labels
        if self.ignore_index is not None:
            ii = ctx.emit1(CastLike(), ctx.const(
                np.asarray(self.ignore_index, np.int64)), labels)
            ign = ctx.emit1(SimpleBinary("eq"), labels, ii)
            zero = ctx.emit1(CastLike(), ctx.const(
                np.asarray(0, np.int64)), labels)
            safe = ctx.emit1(Where(), ign, zero, labels)
        pick = _pick_class(ctx, x, safe)
        neg = ctx.emit1(SimpleUnary("neg"), pick)
        return [_nll_reduce(ctx, neg, labels, weights, self.reduction,
                            self.ignore_index)]
