"""Sequence + Optional symbolic ops (ONNX sequence/optional type
surfaces): SequenceEmpty/Construct/Insert/At/Length/Erase,
SplitToSequence, ConcatFromSequence, SequenceMap, Optional,
OptionalGetElement, OptionalHasElement.

Sequence values are python lists of ndarrays; optionals are OptionalVal
wrappers. These execute directly in the interpreter (`eval_direct`,
like If/Scan/Loop) — sequences are host-side containers by nature, the
compiled TPU paths never carry them (reference treats the sequence ops
the same way: interpreter-tier, tests/onnx_testing.rs sequence cases).

The port's copy of whisper_tensor_tpu/symbolic_graph/ops/sequence.py,
with the ONNX re-export hook `sub_graph_attrs` that
symbolic_graph/export.py reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .base import Operation, register


class OptionalVal:
    """ONNX optional<T>: holds a tensor/sequence or nothing."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value


@register("SequenceEmpty")
@dataclass
class SequenceEmpty(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        return [[]]


@register("SequenceConstruct")
@dataclass
class SequenceConstruct(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        return [[np.asarray(v) for v in inputs]]


@register("SequenceInsert")
@dataclass
class SequenceInsert(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        seq = list(inputs[0])
        t = np.asarray(inputs[1])
        pos = (int(np.asarray(inputs[2]).reshape(()))
               if len(inputs) > 2 and inputs[2] is not None else len(seq))
        seq.insert(pos if pos >= 0 else len(seq) + pos + 1, t)
        return [seq]


@register("SequenceAt")
@dataclass
class SequenceAt(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        return [np.asarray(inputs[0][int(np.asarray(inputs[1]).reshape(()))])]


@register("SequenceLength")
@dataclass
class SequenceLength(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        return [np.asarray(len(inputs[0]), np.int64)]


@register("SequenceErase")
@dataclass
class SequenceErase(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        seq = list(inputs[0])
        pos = (int(np.asarray(inputs[1]).reshape(()))
               if len(inputs) > 1 and inputs[1] is not None
               else len(seq) - 1)
        seq.pop(pos)
        return [seq]


@register("SplitToSequence")
@dataclass
class SplitToSequence(Operation):
    axis: int = 0
    keepdims: int = 1

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0), attrs.i("keepdims", 1))

    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        x = np.asarray(inputs[0])
        ax = self.axis % x.ndim
        split = inputs[1] if len(inputs) > 1 and inputs[1] is not None \
            else None
        if split is None:
            parts = [np.take(x, i, axis=ax) for i in range(x.shape[ax])]
            if self.keepdims:
                parts = [np.expand_dims(p, ax) for p in parts]
            return [parts]
        sp = np.asarray(split).reshape(-1)
        if sp.size == 1 and np.asarray(split).ndim == 0:
            n = int(sp[0])
            sizes = [n] * (x.shape[ax] // n)
            rem = x.shape[ax] - sum(sizes)
            if rem:
                sizes.append(rem)
        else:
            sizes = [int(v) for v in sp]
        offs = np.cumsum([0] + sizes)
        parts = [np.take(x, range(offs[i], offs[i + 1]), axis=ax)
                 for i in range(len(sizes))]
        return [parts]


@register("ConcatFromSequence")
@dataclass
class ConcatFromSequence(Operation):
    axis: int = 0
    new_axis: int = 0

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls(attrs.i("axis", 0), attrs.i("new_axis", 0))

    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        seq = [np.asarray(v) for v in inputs[0]]
        if self.new_axis:
            return [np.stack(seq, axis=self.axis)]
        return [np.concatenate(seq, axis=self.axis)]


@register("SequenceMap")
class SequenceMap(Operation):
    """Map a nested graph over sequence elements; additional inputs that
    are sequences map pairwise, plain tensors broadcast."""

    def __init__(self):
        self.body = None

    @classmethod
    def from_onnx(cls, node, attrs, opset):
        return cls()

    def _bind_subgraphs(self, node, attrs, resolver, store, opsets,
                        base_dir):
        from ..ir import SymbolicGraph

        self.body = SymbolicGraph._from_graph_proto(
            attrs.g("body"), resolver, store, opsets, base_dir)

    def sub_graphs(self):
        return [self.body] if self.body is not None else []

    def sub_graph_attrs(self):
        return {"body": self.body} if self.body is not None else {}

    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        body = self.body
        in_names = [body.tensors[t].name for t in body.inputs]
        out_names = [body.tensors[t].name for t in body.outputs]
        n = len(inputs[0])
        outs: List[List[np.ndarray]] = [[] for _ in out_names]
        for i in range(n):
            feeds = {}
            for j, v in enumerate(inputs):
                feeds[in_names[j]] = (v[i] if isinstance(v, list)
                                      else np.asarray(v))
            res = backend.run(body, feeds, outer_env=outer_env)
            for k, nm in enumerate(out_names):
                outs[k].append(np.asarray(res[nm]))
        return outs[:n_outputs]


@register("Optional")
@dataclass
class OptionalOp(Operation):
    OP_TYPE = "Optional"

    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        if not inputs or inputs[0] is None:
            return [OptionalVal(None)]
        return [OptionalVal(inputs[0])]


@register("OptionalGetElement")
@dataclass
class OptionalGetElement(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        v = inputs[0]
        if isinstance(v, OptionalVal):
            if v.value is None:
                raise ValueError("OptionalGetElement on an empty optional")
            v = v.value
        return [v if isinstance(v, list) else np.asarray(v)]


@register("OptionalHasElement")
@dataclass
class OptionalHasElement(Operation):
    def eval_direct(self, backend, inputs, outer_env, n_outputs):
        if not inputs or inputs[0] is None:
            return [np.asarray(False)]
        v = inputs[0]
        if isinstance(v, OptionalVal):
            return [np.asarray(v.value is not None)]
        return [np.asarray(True)]
