"""Shape-manipulation milli ops (Shape, Reshape, Transpose, Squeeze,
Unsqueeze, Expand, Slice, Concat, GatherShape, Split, Pad) and their
PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/shape.py
(numpy `eval`, shape inference and the autodiff `backward` rules; no
`to_jax`), with SumTo, the gradient's broadcast reducer. Shape arguments
(Reshape's target, axes, Split sizes, Slice bounds, Pad amounts) must be
host values: the executor folds them, or lifts the graph inputs they
come from (need_static). The lowerings reuse the classes' own shape
arithmetic (`_target`, `_perm`, `_axes`, `_expand`, `_sizes`,
`_indexer`, `_pairs`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ...dtype import DType
from ...scalar_info import ScalarInfo
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp, Phase
from ..registry import lowering, need_static




@dataclass
class Shape(MilliOp):
    """Tensor -> 1-D i64 shape. start/end slice per ONNX Shape-15."""

    start: int = 0
    end: Optional[int] = None
    KIND = "Shape"

    def _slice(self, rank: int):
        s = self.start if self.start >= 0 else self.start + rank
        e = self.end if self.end is not None else rank
        if e < 0:
            e += rank
        return max(0, min(s, rank)), max(0, min(e, rank))

    def eval(self, inputs):
        sh = inputs[0].shape
        s, e = self._slice(len(sh))
        return [np.asarray(sh[s:e], dtype=np.int64)]


    def infer(self, infos):
        i = infos[0]
        dims = i.dims()
        if dims is not None:
            s, e = self._slice(len(dims))
            sub = dims[s:e]
            if all(d.is_known for d in sub):
                return [TensorInfo.numeric(np.asarray([d.value() for d in sub], dtype=np.int64))]
            return [TensorInfo.shaped(DType.I64, [len(sub)])]
        if i.rank is not None:
            s, e = self._slice(i.rank)
            return [TensorInfo.shaped(DType.I64, [e - s])]
        return [TensorInfo.ranked(DType.I64, 1)]


@dataclass
class Reshape(MilliOp):
    """data, shape(i64) -> reshaped. ONNX semantics: 0 copies dim
    (unless allowzero), -1 infers."""

    allowzero: bool = False
    KIND = "Reshape"

    def _target(self, in_shape, spec) -> tuple:
        spec = [int(x) for x in spec]
        out = []
        for i, d in enumerate(spec):
            if d == 0 and not self.allowzero:
                out.append(in_shape[i])
            else:
                out.append(d)
        if -1 in out:
            n = 1
            for d in in_shape:
                n *= d
            known = 1
            for d in out:
                if d != -1:
                    known *= d
            out[out.index(-1)] = n // known if known else 0
        return tuple(out)

    def eval(self, inputs):
        data, spec = inputs
        return [data.reshape(self._target(data.shape, spec.reshape(-1)))]


    def infer(self, infos):
        data, spec = infos
        if spec.level is Level.NUMERIC:
            sv = spec.value.reshape(-1)
            cs = data.concrete_shape()
            if data.level is Level.NUMERIC:
                return [TensorInfo.numeric(self.eval([data.value, spec.value])[0])]
            if cs is not None:
                return [TensorInfo.shaped(data.dtype, self._target(cs, sv))]
            # partially static: fully-positive specs give the shape directly
            iv = [int(x) for x in sv]
            if all(d > 0 for d in iv):
                return [TensorInfo.shaped(data.dtype, iv)]
            dims = data.dims()
            if dims is not None and all(d != -1 for d in iv):
                out = [dims[i] if (d == 0 and not self.allowzero) else ScalarInfo.of(d)
                       for i, d in enumerate(iv)]
                return [TensorInfo.shaped(data.dtype, out)]
            return [TensorInfo.ranked(data.dtype, len(iv))]
        sd = spec.dims()
        if sd is not None and sd[0].is_known:
            return [TensorInfo.ranked(data.dtype, int(sd[0].value()))]
        return [TensorInfo.minimal(data.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None, None]
        P = Phase.BACKWARD
        shp = b.op1(Shape(), node.inputs[0], phase=P)
        return [b.op1(Reshape(), g, shp, phase=P), None]


@dataclass
class Transpose(MilliOp):
    perm: Optional[List[int]] = None  # None = reverse axes
    swap_last2: bool = False          # transpose last two dims (matmul bwd)
    KIND = "Transpose"

    def _perm(self, rank: int) -> List[int]:
        if self.swap_last2:
            p = list(range(rank))
            if rank >= 2:
                p[-1], p[-2] = p[-2], p[-1]
            return p
        return list(self.perm) if self.perm is not None else list(reversed(range(rank)))

    def eval(self, inputs):
        x = inputs[0]
        return [np.transpose(x, self._perm(x.ndim))]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        dims = i.dims()
        if dims is not None:
            p = self._perm(len(dims))
            return [TensorInfo.shaped(i.dtype, [dims[j] for j in p])]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank)]
        return [i]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None]
        P = Phase.BACKWARD
        if self.swap_last2:
            return [b.op1(Transpose(swap_last2=True), g, phase=P)]
        if self.perm is None:
            return [b.op1(Transpose(), g, phase=P)]
        inv = [0] * len(self.perm)
        for i, p in enumerate(self.perm):
            inv[p] = i
        return [b.op1(Transpose(perm=inv), g, phase=P)]


@dataclass
class Squeeze(MilliOp):
    axes: Optional[List[int]] = None  # None = squeeze all size-1 dims
    KIND = "Squeeze"

    def _axes(self, shape, axes_arr=None) -> List[int]:
        if axes_arr is not None:
            return sorted(int(a) % len(shape) for a in np.asarray(axes_arr).reshape(-1))
        if self.axes is None:
            return [i for i, d in enumerate(shape) if d == 1]
        return sorted(a % len(shape) for a in self.axes)

    def eval(self, inputs):
        x = inputs[0]
        axes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        return [np.squeeze(x, axis=tuple(self._axes(x.shape, axes_arr)))]


    def infer(self, infos):
        i = infos[0]
        axes_info = infos[1] if len(infos) > 1 else None
        axes_arr = (axes_info.value if axes_info is not None
                    and axes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and axes_arr is None:
            return [TensorInfo.minimal(i.dtype)]
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([axes_arr] if axes_arr is not None else [])
            return [TensorInfo.numeric(self.eval(vals)[0])]
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else self.axes)
        dims = i.dims()
        if dims is not None:
            if axes is None:
                if not all(d.is_known for d in dims):
                    return [TensorInfo.minimal(i.dtype)]
                ax = [j for j, d in enumerate(dims) if d.value() == 1]
            else:
                ax = [a % len(dims) for a in axes]
            return [TensorInfo.shaped(i.dtype, [d for j, d in enumerate(dims) if j not in ax])]
        if i.rank is not None and axes is not None:
            return [TensorInfo.ranked(i.dtype, i.rank - len(axes))]
        return [TensorInfo.minimal(i.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None]
        P = Phase.BACKWARD
        shp = b.op1(Shape(), node.inputs[0], phase=P)
        return [b.op1(Reshape(), g, shp, phase=P)]


@dataclass
class Unsqueeze(MilliOp):
    axes: List[int] = field(default_factory=list)
    KIND = "Unsqueeze"

    def _expand(self, shape, axes_arr=None) -> tuple:
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else self.axes)
        out_rank = len(shape) + len(axes)
        ax = sorted(a % out_rank for a in axes)
        out = []
        src = 0
        for i in range(out_rank):
            if i in ax:
                out.append(1)
            else:
                out.append(shape[src])
                src += 1
        return tuple(out)

    def eval(self, inputs):
        x = inputs[0]
        axes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        return [x.reshape(self._expand(x.shape, axes_arr))]


    def infer(self, infos):
        i = infos[0]
        axes_info = infos[1] if len(infos) > 1 else None
        axes_arr = (axes_info.value if axes_info is not None
                    and axes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and axes_arr is None:
            return [TensorInfo.minimal(i.dtype)]
        axes = ([int(a) for a in np.asarray(axes_arr).reshape(-1)]
                if axes_arr is not None else list(self.axes))
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([axes_arr] if axes_arr is not None else [])
            return [TensorInfo.numeric(self.eval(vals)[0])]
        dims = i.dims()
        if dims is not None:
            out_rank = len(dims) + len(axes)
            ax = sorted(a % out_rank for a in axes)
            out, src = [], 0
            for j in range(out_rank):
                if j in ax:
                    out.append(ScalarInfo.of(1))
                else:
                    out.append(dims[src])
                    src += 1
            return [TensorInfo.shaped(i.dtype, out)]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank + len(axes))]
        return [TensorInfo.minimal(i.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None]
        P = Phase.BACKWARD
        shp = b.op1(Shape(), node.inputs[0], phase=P)
        return [b.op1(Reshape(), g, shp, phase=P)]


@dataclass
class Expand(MilliOp):
    """data, shape(i64) -> broadcast (two-way per ONNX Expand)."""

    KIND = "Expand"

    @staticmethod
    def _target(in_shape, spec) -> tuple:
        spec = [int(x) for x in spec]
        return tuple(np.broadcast_shapes(tuple(in_shape), tuple(spec)))

    def eval(self, inputs):
        data, spec = inputs
        return [np.broadcast_to(data, self._target(data.shape, spec.reshape(-1))).copy()]


    def infer(self, infos):
        data, spec = infos
        if data.level is Level.NUMERIC and spec.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([data.value, spec.value])[0])]
        if spec.level is Level.NUMERIC:
            sv = [int(x) for x in spec.value.reshape(-1)]
            dims = data.dims()
            if dims is not None:
                bd_in = [d if d.is_known else None for d in dims]
                n = max(len(sv), len(dims))
                out = []
                for k in range(n):
                    a = dims[len(dims) - n + k] if len(dims) - n + k >= 0 else ScalarInfo.of(1)
                    s = sv[len(sv) - n + k] if len(sv) - n + k >= 0 else 1
                    if s == 1:
                        out.append(a)
                    elif a.is_known:
                        out.append(ScalarInfo.of(max(int(a.value()), s)))
                    else:
                        out.append(ScalarInfo.of(s))
                return [TensorInfo.shaped(data.dtype, out)]
            return [TensorInfo.ranked(data.dtype, len(sv))]
        return [TensorInfo.minimal(data.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None, None]
        P = Phase.BACKWARD
        shp = b.op1(Shape(), node.inputs[0], phase=P)
        return [b.op1(SumTo(), g, shp, phase=P), None]


@dataclass
class SumTo(MilliOp):
    """data, target_shape(i64) -> sum-reduce data down to target shape.

    The broadcast-gradient reducer (reference src/milli_graph/ops/sum_to.rs).
    """

    KIND = "SumTo"

    @staticmethod
    def _reduce(data, tgt):
        tgt = tuple(int(x) for x in np.asarray(tgt).reshape(-1))
        while data.ndim > len(tgt):
            data = data.sum(axis=0)
        for ax, (d, t) in enumerate(zip(data.shape, tgt)):
            if d != t:
                if t != 1:
                    raise ValueError(f"SumTo: cannot reduce {data.shape} to {tgt}")
                data = data.sum(axis=ax, keepdims=True)
        return data

    def eval(self, inputs):
        data, tgt = inputs
        x = data
        if x.dtype.kind == "f" and x.dtype.itemsize < 4:
            out = self._reduce(x.astype(np.float32), tgt).astype(x.dtype)
        else:
            out = self._reduce(x, tgt)
        return [np.ascontiguousarray(out)]

    def infer(self, infos):
        data, tgt = infos
        if data.level is Level.NUMERIC and tgt.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([data.value, tgt.value])[0])]
        if tgt.level is Level.NUMERIC:
            return [TensorInfo.shaped(data.dtype, [int(x) for x in tgt.value.reshape(-1)])]
        return [TensorInfo.minimal(data.dtype)]


@dataclass
class Slice(MilliOp):
    """data, starts, ends, axes?, steps? (ONNX Slice-13 runtime inputs)."""

    KIND = "Slice"

    @staticmethod
    def _indexer(shape, starts, ends, axes, steps):
        rank = len(shape)
        starts = [int(x) for x in np.asarray(starts).reshape(-1)]
        ends = [int(x) for x in np.asarray(ends).reshape(-1)]
        axes = list(range(len(starts))) if axes is None else [int(a) % rank for a in np.asarray(axes).reshape(-1)]
        steps = [1] * len(starts) if steps is None else [int(s) for s in np.asarray(steps).reshape(-1)]
        idx = [slice(None)] * rank
        for s, e, a, st in zip(starts, ends, axes, steps):
            d = shape[a]
            s = s + d if s < 0 else s
            e = e + d if e < 0 else e
            if st > 0:
                s2 = min(max(s, 0), d)
                e2 = min(max(e, 0), d)
                idx[a] = slice(s2, e2, st)
            else:
                # ONNX: start clamps to [0, d-1]; end to [-1, d-1] where -1
                # (i.e. "one before element 0") maps to Python's None.
                s2 = min(max(s, 0), d - 1)
                e2 = min(max(e, -1), d - 1)
                idx[a] = slice(s2, None if e2 < 0 else e2, st)
        return tuple(idx)

    def eval(self, inputs):
        data = inputs[0]
        starts, ends = inputs[1], inputs[2]
        axes = inputs[3] if len(inputs) > 3 and inputs[3] is not None else None
        steps = inputs[4] if len(inputs) > 4 and inputs[4] is not None else None
        return [np.ascontiguousarray(data[self._indexer(data.shape, starts, ends, axes, steps)])]


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        data = infos[0]
        statics = [i.value if i.level is Level.NUMERIC else None for i in infos]
        cs = data.concrete_shape()
        if cs is not None and statics[1] is not None and statics[2] is not None \
                and (len(infos) <= 3 or statics[3] is not None) \
                and (len(infos) <= 4 or statics[4] is not None):
            idx = self._indexer(cs, statics[1], statics[2],
                                statics[3] if len(infos) > 3 else None,
                                statics[4] if len(infos) > 4 else None)
            out = []
            for d, sl in zip(cs, idx):
                out.append(len(range(*sl.indices(d))))
            return [TensorInfo.shaped(data.dtype, out)]
        if data.rank is not None:
            return [TensorInfo.ranked(data.dtype, data.rank)]
        return [TensorInfo.minimal(data.dtype)]

    def backward(self, b, node, out_grads):
        """grad_data scatters the output grad back to the input shape:
        unit steps are a zero Pad; strided steps interleave step-1 zero
        rows (unsqueeze/pad/merge) first; negative steps reverse before
        interleaving. Needs build-time starts/ends/axes/steps (Constant
        producers or NUMERIC infos) and a concrete input shape."""
        g = out_grads[0]
        if g is None:
            return [None] * len(node.inputs)

        def _static(tid):
            if tid is None:
                return None
            info = b.tensors[tid].info
            if info is not None and info.level is Level.NUMERIC:
                return np.asarray(info.value)
            for n in b.nodes:
                if tid in n.outputs and getattr(n.op, "KIND", None) == "Constant":
                    return np.asarray(n.op.value)
            raise NotImplementedError("Slice backward: dynamic start/end")

        data = node.inputs[0]
        dinfo = b.tensors[data].info
        cs = dinfo.concrete_shape() if dinfo is not None else None
        if cs is None:
            raise NotImplementedError("Slice backward: unknown input shape")
        starts = _static(node.inputs[1])
        ends = _static(node.inputs[2])
        axes = _static(node.inputs[3]) if len(node.inputs) > 3 else None
        steps = _static(node.inputs[4]) if len(node.inputs) > 4 else None
        idx = self._indexer(cs, starts, ends, axes, steps)
        from .basic import Constant

        P = Phase.BACKWARD

        def const(vals):
            return b.op1(Constant(np.asarray(vals, dtype=np.int64)), phase=P)

        rank = len(cs)
        # current (static) shape of the grad being transformed
        shape_now = [len(range(*sl.indices(d))) for d, sl in zip(cs, idx)]
        cur = g
        begin, end_pad = [], []
        for a, (d, sl) in enumerate(zip(cs, idx)):
            lo, hi, st = sl.indices(d)
            n = shape_now[a]
            if st < 0:
                # reverse along `a` so positions ascend, then treat as +|st|
                cur = b.op1(Slice(), cur, const([-1]), const([-(n + 1)]),
                            const([a]), const([-1]), phase=P)
                lo = lo + (n - 1) * st
                st = -st
            if st > 1 and n > 0:
                # interleave st-1 zeros between grad rows: unsqueeze a+1,
                # pad that axis to st, merge, trim the trailing zeros
                cur = b.op1(Unsqueeze(axes=[a + 1]), cur, phase=P)
                pv = [0] * (2 * (rank + 1))
                pv[rank + 1 + a + 1] = st - 1   # pad after, axis a+1
                cur = b.op1(Pad(mode="constant"), cur, const(pv), phase=P)
                tgt = list(shape_now)
                tgt[a] = n * st
                cur = b.op1(Reshape(), cur, const(tgt), phase=P)
                cur = b.op1(Slice(), cur, const([0]),
                            const([(n - 1) * st + 1]), const([a]), phase=P)
                shape_now[a] = (n - 1) * st + 1
            begin.append(lo if n > 0 else 0)
            end_pad.append(d - (lo if n > 0 else 0) - shape_now[a])
        pads = const(begin + end_pad)
        gd = b.op1(Pad(mode="constant"), cur, pads, phase=P)
        return [gd] + [None] * (len(node.inputs) - 1)


@dataclass
class Concat(MilliOp):
    axis: int = 0
    KIND = "Concat"

    def eval(self, inputs):
        return [np.concatenate(inputs, axis=self.axis)]


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dt = infos[0].dtype
        dimss = [i.dims() for i in infos]
        if all(d is not None for d in dimss):
            rank = len(dimss[0])
            ax = self.axis % rank
            out = list(dimss[0])
            acc = dimss[0][ax]
            ok = True
            for d in dimss[1:]:
                try:
                    acc = acc + d[ax]
                except ValueError:
                    ok = False
                    break
            if ok:
                out[ax] = acc
                return [TensorInfo.shaped(dt, out)]
            return [TensorInfo.ranked(dt, rank)]
        ranks = [i.rank for i in infos]
        if all(r is not None for r in ranks):
            return [TensorInfo.ranked(dt, ranks[0])]
        return [TensorInfo.minimal(dt)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None] * len(node.inputs)
        P = Phase.BACKWARD
        from .basic import Constant

        grads = []
        # split grad by each input's length along axis using Slice with
        # runtime Shape-derived boundaries.

        offset = None
        for idx, inp in enumerate(node.inputs):
            shp = b.op1(Shape(), inp, phase=P)
            ax_const = b.op1(Constant(np.asarray([self.axis], dtype=np.int64)), phase=P)
            ln = b.op1(GatherShape(self.axis), shp, phase=P)
            if offset is None:
                zero = b.op1(Constant(np.asarray([0], dtype=np.int64)), phase=P)
                start = zero
            else:
                start = offset
            from .basic import SimpleBinary

            end = b.op1(SimpleBinary("add"), start, ln, phase=P)
            gslice = b.op1(Slice(), g, start, end, ax_const, phase=P)
            grads.append(gslice)
            offset = end
        return grads


@dataclass
class GatherShape(MilliOp):
    """Pick element [axis] from a 1-D i64 shape vector (helper op)."""

    index: int = 0
    KIND = "GatherShape"

    def eval(self, inputs):
        v = inputs[0].reshape(-1)
        i = self.index % v.size
        return [np.asarray(v[i:i + 1], dtype=np.int64)]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo.shaped(DType.I64, [1])]


@dataclass
class Split(MilliOp):
    """Static split: sizes resolved at lowering time."""

    axis: int = 0
    sizes: List[int] = field(default_factory=list)
    KIND = "Split"

    num_outputs: int = 0

    @property
    def N_OUTPUTS(self):  # type: ignore[override]
        return self.num_outputs or len(self.sizes)

    def _sizes(self, x_shape, sizes_arr=None) -> List[int]:
        if sizes_arr is not None:
            return [int(v) for v in np.asarray(sizes_arr).reshape(-1)]
        if self.sizes:
            return list(self.sizes)
        # equal split into num_outputs parts (last may be smaller)
        d = x_shape[self.axis % len(x_shape)]
        n = self.num_outputs
        chunk = -(-d // n)
        out = [chunk] * (d // chunk)
        if sum(out) < d:
            out.append(d - sum(out))
        return out

    def eval(self, inputs):
        x = inputs[0]
        sizes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        splits = np.cumsum(self._sizes(x.shape, sizes_arr))[:-1]
        return list(np.split(x, splits, axis=self.axis))


    def infer(self, infos):
        i = infos[0]
        n_out = self.N_OUTPUTS
        sizes_info = infos[1] if len(infos) > 1 else None
        sizes_arr = (sizes_info.value if sizes_info is not None
                     and sizes_info.level is Level.NUMERIC else None)
        if len(infos) > 1 and sizes_arr is None:
            return [TensorInfo.minimal(i.dtype) for _ in range(n_out)]
        if i.level is Level.NUMERIC:
            vals = [i.value] + ([sizes_arr] if sizes_arr is not None else [])
            return [TensorInfo.numeric(v) for v in self.eval(vals)]
        cs = i.concrete_shape()
        if cs is not None:
            sizes = self._sizes(cs, sizes_arr)
            ax = self.axis % len(cs)
            outs = []
            for s in sizes:
                d = list(cs)
                d[ax] = s
                outs.append(TensorInfo.shaped(i.dtype, d))
            return outs
        return [TensorInfo.minimal(i.dtype) for _ in range(n_out)]

    def backward(self, b, node, out_grads):
        P = Phase.BACKWARD
        if any(g is None for g in out_grads):
            raise NotImplementedError("Split backward with missing grads")
        cat = b.add_op(Concat(axis=self.axis), list(out_grads), phase=P)[0]
        return [cat]


@dataclass
class Pad(MilliOp):
    """data, pads(i64 2*rank or 2*len(axes)), value?, axes? — ONNX Pad-18."""

    mode: str = "constant"  # constant | reflect | edge | wrap
    KIND = "Pad"

    @staticmethod
    def _pairs(rank, pads, axes):
        pads = [int(x) for x in np.asarray(pads).reshape(-1)]
        n = len(pads) // 2
        axes = list(range(n)) if axes is None else [int(a) % rank for a in np.asarray(axes).reshape(-1)]
        out = [(0, 0)] * rank
        for i, a in enumerate(axes):
            out[a] = (pads[i], pads[i + n])
        return out

    def eval(self, inputs):
        data = inputs[0]
        pads = inputs[1]
        cval = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        axes = inputs[3] if len(inputs) > 3 and inputs[3] is not None else None
        pp = self._pairs(data.ndim, pads, axes)
        neg = any(p < 0 or q < 0 for p, q in pp)
        if neg:
            # negative pads crop first
            idx = tuple(slice(max(0, -p), (d + min(0, q)) if q < 0 else None)
                        for (p, q), d in zip(pp, data.shape))
            data = data[idx]
            pp = [(max(0, p), max(0, q)) for p, q in pp]
        mode = {"constant": "constant", "reflect": "reflect", "edge": "edge", "wrap": "wrap"}[self.mode]
        if mode == "constant":
            cv = 0 if cval is None else np.asarray(cval).reshape(-1)[0]
            out = np.pad(data, pp, mode="constant", constant_values=cv)
        else:
            out = np.pad(data, pp, mode=mode)
        return [out.astype(data.dtype, copy=False)]


    def infer(self, infos):
        vals = []
        for i in infos:
            if i is None or i.level is not Level.NUMERIC:
                vals = None
                break
            vals.append(i.value)
        if vals is not None:
            return [TensorInfo.numeric(self.eval(vals)[0])]
        data = infos[0]
        pads = infos[1]
        if pads.level is Level.NUMERIC and data.dims() is not None:
            axes_info = infos[3] if len(infos) > 3 else None
            axes = axes_info.value if axes_info is not None and axes_info.level is Level.NUMERIC else None
            if len(infos) > 3 and axes is None:
                pass
            else:
                dims = list(data.dims())
                pp = self._pairs(len(dims), pads.value, axes)
                out = []
                for (p, q), d in zip(pp, dims):
                    out.append(d + ScalarInfo.of(p + q))
                return [TensorInfo.shaped(data.dtype, out)]
        if data.rank is not None:
            return [TensorInfo.ranked(data.dtype, data.rank)]
        return [TensorInfo.minimal(data.dtype)]


# -- lowerings ----------------------------------------------------------


@lowering("Shape")
def shape(op, inputs, static, device):
    sh = tuple(inputs[0].shape)
    s, e = op._slice(len(sh))
    return [torch.tensor(sh[s:e], dtype=torch.int64, device=device)]


@lowering("Reshape")
def reshape(op, inputs, static, device):
    spec = need_static(static, 1, "Reshape").reshape(-1)
    x = inputs[0]
    return [x.reshape(op._target(tuple(x.shape), spec))]


@lowering("Transpose")
def transpose(op, inputs, static, device):
    x = inputs[0]
    return [x.permute(op._perm(x.ndim))]


@lowering("Squeeze")
def squeeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = need_static(static, 1, "Squeeze") if len(inputs) > 1 else None
    axes = set(op._axes(tuple(x.shape), axes_arr))
    return [x.reshape([d for i, d in enumerate(x.shape) if i not in axes])]


@lowering("Unsqueeze")
def unsqueeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = (need_static(static, 1, "Unsqueeze") if len(inputs) > 1
                else None)
    return [x.reshape(op._expand(tuple(x.shape), axes_arr))]


@lowering("Split")
def split(op, inputs, static, device):
    x = inputs[0]
    sizes_arr = need_static(static, 1, "Split") if len(inputs) > 1 else None
    sizes = op._sizes(tuple(x.shape), sizes_arr)
    return list(torch.split(x, sizes, dim=op.axis))


@lowering("Expand")
def expand(op, inputs, static, device):
    x = inputs[0]
    spec = need_static(static, 1, "Expand").reshape(-1)
    return [x.expand(op._target(tuple(x.shape), spec))]


@lowering("SumTo")
def sum_to(op, inputs, static, device):
    x = inputs[0]
    tgt = [int(v) for v in need_static(static, 1, "SumTo").reshape(-1)]
    lead = x.ndim - len(tgt)
    dims = list(range(lead))
    for ax, t in enumerate(tgt):
        d = x.shape[lead + ax]
        if d != t:
            if t != 1:
                raise ValueError(f"SumTo: cannot reduce {tuple(x.shape)} "
                                 f"to {tuple(tgt)}")
            dims.append(lead + ax)
    if not dims:
        return [x]
    # 16-bit floats sum in f32 and round once, as the oracle
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = (x.float() if low else x).sum(dim=dims).reshape(tgt)
    return [out.to(x.dtype)]


def take_range(x: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    """x[..., sl, ...] along `axis` for any step (torch indexing takes
    no negative step)."""
    start, stop, step = sl.indices(x.shape[axis])
    if step == 1:
        return x.narrow(axis, start, max(stop - start, 0))
    idx = torch.arange(start, stop, step, device=x.device)
    return x.index_select(axis, idx)


@lowering("Slice")
def slice_(op, inputs, static, device):
    data = inputs[0]
    starts = need_static(static, 1, "Slice")
    ends = need_static(static, 2, "Slice")
    axes = (need_static(static, 3, "Slice")
            if len(inputs) > 3 and inputs[3] is not None else None)
    steps = (need_static(static, 4, "Slice")
             if len(inputs) > 4 and inputs[4] is not None else None)
    out = data
    for a, sl in enumerate(op._indexer(tuple(data.shape), starts, ends,
                                       axes, steps)):
        if sl != slice(None):
            out = take_range(out, a, sl)
    return [out]


@lowering("Concat")
def concat(op, inputs, static, device):
    xs = [x for x in inputs if x is not None]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [torch.cat([x.to(dt) for x in xs], dim=op.axis)]


@lowering("GatherShape")
def gather_shape(op, inputs, static, device):
    v = inputs[0].reshape(-1)
    i = op.index % v.numel()
    return [v[i:i + 1].to(torch.int64)]


@lowering("Pad")
def pad(op, inputs, static, device):
    data = inputs[0]
    pads = need_static(static, 1, "Pad")
    axes = (need_static(static, 3, "Pad")
            if len(inputs) > 3 and inputs[3] is not None else None)
    pp = op._pairs(data.ndim, pads, axes)
    if any(p < 0 or q < 0 for p, q in pp):
        # negative pads crop first
        for a, ((p, q), d) in enumerate(zip(pp, data.shape)):
            if p < 0 or q < 0:
                lo = max(0, -p)
                hi = d + min(0, q)
                data = data.narrow(a, lo, max(hi - lo, 0))
        pp = [(max(0, p), max(0, q)) for p, q in pp]
    if op.mode == "constant":
        cv = 0
        if len(inputs) > 2 and inputs[2] is not None:
            cv = (static[2] if static[2] is not None
                  else inputs[2].cpu()).reshape(-1)[0].item()
        flat = [v for p, q in reversed(pp) for v in (p, q)]
        if data.dtype.is_floating_point or data.dtype == torch.bool:
            return [torch.nn.functional.pad(data, flat, value=cv)]
        out = torch.full([d + p + q for d, (p, q) in zip(data.shape, pp)],
                         cv, dtype=data.dtype, device=data.device)
        idx = tuple(slice(p, p + d) for d, (p, _) in zip(data.shape, pp))
        out[idx] = data
        return [out]
    # edge / reflect / wrap: gather each padded axis by numpy's own index
    # pattern
    mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}[op.mode]
    for a, (p, q) in enumerate(pp):
        if p or q:
            idx = np.pad(np.arange(data.shape[a]), (p, q), mode=mode)
            data = data.index_select(
                a, torch.as_tensor(idx, device=data.device))
    return [data]
