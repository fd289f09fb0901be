"""Reduction milli ops: Reduce*, ArgMax/ArgMin, CumSum, TopK, NonZero,
and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/
reduce.py (numpy `eval`, shape inference and Reduce's autodiff
`backward`; no `to_jax`). Reduce axes
and TopK's k must be host values (NeedsStatic lifts them). NonZero's
output shape depends on the data: the executor does not replay a plan
that folded a shape read after it (backends/torch_exec/compiler.py).
Low-precision floats reduce in f32 and round back once, as the oracle;
integer sums, products, minima and maxima keep their type (wrapping).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...dtype import DType
from ...scalar_info import ScalarInfo
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp, Phase
from ..registry import lowering, need_static
from .lowering_common import (down, from_order_key, narrow, np_dtype,
                              order_key, up, widen)

_REDUCE_FNS = {
    "sum": (np.sum, "sum"),
    "mean": (np.mean, "mean"),
    "prod": (np.prod, "prod"),
    "min": (np.min, "min"),
    "max": (np.max, "max"),
    "l2": (lambda x, axis, keepdims: np.sqrt(np.sum(np.square(x), axis=axis, keepdims=keepdims)), "_l2"),
    "logsumexp": (None, "_lse"),
    "sumsquare": (lambda x, axis, keepdims: np.sum(np.square(x), axis=axis, keepdims=keepdims), "_ss"),
    "l1": (lambda x, axis, keepdims: np.sum(np.abs(x), axis=axis, keepdims=keepdims), "_l1"),
}


@dataclass
class Reduce(MilliOp):
    mode: str = "sum"
    axes: Optional[List[int]] = None  # None = all axes
    keepdims: bool = True
    noop_with_empty_axes: bool = False
    KIND = "Reduce"

    def _axes(self, rank: int, axes_arr=None):
        axes = self.axes
        if axes_arr is not None:
            axes = [int(a) for a in np.asarray(axes_arr).reshape(-1)]
        if axes is None or len(axes) == 0:
            if self.noop_with_empty_axes and axes is not None:
                return ()
            if self.noop_with_empty_axes:
                return ()
            return tuple(range(rank))
        return tuple(sorted(a % rank for a in axes))

    def _empty_set(self, x, ax, xp):
        """ONNX empty-set reduction identities (a reduced dim is 0):
        sum/l1/l2/sumsquare -> 0, prod -> 1, logsum/logsumexp -> -inf,
        max -> -inf/int-min, min -> +inf/int-max, mean -> nan."""
        shape = [1 if a in ax else d for a, d in enumerate(x.shape)] \
            if self.keepdims else \
            [d for a, d in enumerate(x.shape) if a not in ax]
        is_int = x.dtype.kind in "iub"
        fills = {"sum": 0, "l1": 0, "l2": 0, "sumsquare": 0, "prod": 1,
                 "logsum": -np.inf, "logsumexp": -np.inf, "mean": np.nan,
                 "max": (np.iinfo(x.dtype).min if is_int else -np.inf),
                 "min": (np.iinfo(x.dtype).max if is_int else np.inf)}
        return np.full(shape, fills[self.mode], dtype=x.dtype)

    def eval(self, inputs):
        x = inputs[0]
        axes_arr = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        ax = self._axes(x.ndim, axes_arr)
        if len(ax) == 0:
            return [x.copy()]
        if any(x.shape[a] == 0 for a in ax):
            return [self._empty_set(x, ax, np)]
        from .common import downcast_result, upcast_for_compute

        xc, orig = upcast_for_compute(x)
        m = self.mode
        if m == "logsumexp":
            mx = np.max(xc, axis=ax, keepdims=True)
            mx0 = np.where(np.isinf(mx), 0.0, mx)
            out = np.log(np.sum(np.exp(xc - mx0), axis=ax, keepdims=self.keepdims)) + (
                mx0 if self.keepdims else np.squeeze(mx0, axis=ax))
        elif m in ("l2", "sumsquare", "l1"):
            out = _REDUCE_FNS[m][0](xc, ax, self.keepdims)
        else:
            out = _REDUCE_FNS[m][0](xc, axis=ax, keepdims=self.keepdims)
        out = np.asarray(out)
        if m in ("sum", "prod", "min", "max") and x.dtype.kind in "iub":
            out = out.astype(x.dtype)
        return [downcast_result(out, orig)]


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
        dims = i.dims()
        if dims is not None:
            ax = self._axes(len(dims), axes_arr)
            out = []
            for j, d in enumerate(dims):
                if j in ax:
                    if self.keepdims:
                        out.append(ScalarInfo.of(1))
                else:
                    out.append(d)
            return [TensorInfo.shaped(i.dtype, out)]
        if i.rank is not None:
            r = i.rank if self.keepdims else max(0, i.rank - len(self._axes(i.rank)))
            return [TensorInfo.ranked(i.dtype, r)]
        return [TensorInfo.minimal(i.dtype)]

    def backward(self, b, node, out_grads):
        from .basic import CastLike, Constant, SimpleBinary
        from .shape import Expand, Reshape, Shape, Unsqueeze

        g = out_grads[0]
        if g is None:
            return [None]
        x = node.inputs[0]
        P = Phase.BACKWARD
        if self.mode in ("max", "min"):
            # subgradient: distribute grad equally over arg-extreme ties
            y = node.outputs[0]
            yk, gk = y, g
            if not self.keepdims and self.axes:
                if all(a < 0 for a in self.axes):
                    ax = sorted(self.axes)
                else:
                    info = b.tensors[x].info
                    rank = (info.rank if info is not None
                            and info.rank is not None else None)
                    if rank is None:
                        raise NotImplementedError(
                            "Reduce max/min backward without rank info")
                    ax = list(self._axes(rank))
                yk = b.op1(Unsqueeze(axes=ax), y, phase=P)
                gk = b.op1(Unsqueeze(axes=ax), g, phase=P)
            mask = b.op1(SimpleBinary("eq"), x, yk, phase=P)
            maskf = b.op1(CastLike(), mask, g, phase=P)
            cnt = b.op1(Reduce("sum", self.axes, keepdims=True), maskf, phase=P)
            share = b.op1(SimpleBinary("div"), maskf, cnt, phase=P)
            return [b.op1(SimpleBinary("mul"), gk, share, phase=P)]
        if self.mode in ("prod", "l1", "l2", "sumsquare", "logsumexp"):
            from .basic import SimpleUnary

            y = node.outputs[0]
            yk, gk = y, g
            if not self.keepdims and self.axes:
                if all(a < 0 for a in self.axes):
                    ax = sorted(self.axes)
                else:
                    info = b.tensors[x].info
                    rank = (info.rank if info is not None
                            and info.rank is not None else None)
                    if rank is None:
                        raise NotImplementedError(
                            f"Reduce {self.mode} backward without rank info")
                    ax = list(self._axes(rank))
                yk = b.op1(Unsqueeze(axes=ax), y, phase=P)
                gk = b.op1(Unsqueeze(axes=ax), g, phase=P)

            def bop(mode, a_, c_):
                return b.op1(SimpleBinary(mode), a_, c_, phase=P)

            if self.mode == "prod":
                # d prod/dx_i = prod / x_i (subgradient away from zeros)
                return [bop("mul", gk, bop("div", yk, x))]
            if self.mode == "l1":
                return [bop("mul", gk, b.op1(SimpleUnary("sign"), x,
                                             phase=P))]
            if self.mode == "l2":
                # d sqrt(sum x^2)/dx = x / y
                return [bop("mul", gk, bop("div", x, yk))]
            if self.mode == "sumsquare":
                two = b.op1(CastLike(), b.op1(Constant(
                    np.asarray(2.0, dtype=np.float32)), phase=P), g, phase=P)
                return [bop("mul", gk, bop("mul", two, x))]
            # logsumexp: d/dx = exp(x - y) (the softmax weights)
            e = b.op1(SimpleUnary("exp"), bop("sub", x, yk), phase=P)
            return [bop("mul", gk, e)]
        if self.mode not in ("sum", "mean"):
            raise NotImplementedError(f"backward for Reduce-{self.mode}")
        # re-insert reduced dims if keepdims=False, then broadcast
        if not self.keepdims and self.axes:
            if all(a < 0 for a in self.axes):
                ax = sorted(self.axes)  # negative axes need no rank info
            else:
                info = b.tensors[x].info
                rank = info.rank if info is not None and info.rank is not None else None
                if rank is None:
                    raise NotImplementedError("Reduce backward without rank info")
                ax = list(self._axes(rank))
            g = b.op1(Unsqueeze(axes=ax), g, phase=P)
        # all-axes reduce to scalar: Expand broadcasts directly
        shp = b.op1(Shape(), x, phase=P)
        g = b.op1(Expand(), g, shp, phase=P)
        if self.mode == "mean":
            # divide by number of reduced elements = size(x)/size(g_preexpand)
            from .reduce import SizeOf

            n = b.op1(SizeOf(axes=self.axes), x, phase=P)
            nf = b.op1(CastLike(), n, g, phase=P)
            g = b.op1(SimpleBinary("div"), g, nf, phase=P)
        return [g]


@dataclass
class SizeOf(MilliOp):
    """Product of dims over `axes` (None = all) -> scalar i64 (helper)."""

    axes: Optional[List[int]] = None
    KIND = "SizeOf"

    def eval(self, inputs):
        x = inputs[0]
        ax = range(x.ndim) if not self.axes else [a % x.ndim for a in self.axes]
        n = 1
        for a in ax:
            n *= x.shape[a]
        return [np.asarray(n, dtype=np.int64)]


    def infer(self, infos):
        i = infos[0]
        dims = i.dims()
        if dims is not None:
            ax = range(len(dims)) if not self.axes else [a % len(dims) for a in self.axes]
            n = 1
            for a in ax:
                if not dims[a].is_known:
                    return [TensorInfo.shaped(DType.I64, [])]
                n *= int(dims[a].value())
            return [TensorInfo.numeric(np.asarray(n, dtype=np.int64))]
        return [TensorInfo.shaped(DType.I64, [])]


@dataclass
class ArgMinMax(MilliOp):
    mode: str = "max"  # max | min
    axis: int = 0
    keepdims: bool = True
    select_last_index: bool = False
    KIND = "ArgMinMax"

    def eval(self, inputs):
        x = inputs[0]
        ax = self.axis % x.ndim
        from .common import upcast_for_compute

        xc, _ = upcast_for_compute(x)
        if self.select_last_index:
            xr = np.flip(xc, axis=ax)
            idx = (np.argmax(xr, axis=ax) if self.mode == "max" else np.argmin(xr, axis=ax))
            idx = x.shape[ax] - 1 - idx
        else:
            idx = (np.argmax(xc, axis=ax) if self.mode == "max" else np.argmin(xc, axis=ax))
        idx = idx.astype(np.int64)
        if self.keepdims:
            idx = np.expand_dims(idx, axis=ax)
        return [idx]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        dims = i.dims()
        if dims is not None:
            ax = self.axis % len(dims)
            out = [ScalarInfo.of(1) if j == ax else d for j, d in enumerate(dims)] \
                if self.keepdims else [d for j, d in enumerate(dims) if j != ax]
            return [TensorInfo.shaped(DType.I64, out)]
        if i.rank is not None:
            return [TensorInfo.ranked(DType.I64, i.rank if self.keepdims else i.rank - 1)]
        return [TensorInfo.minimal(DType.I64)]


@dataclass
class CumSum(MilliOp):
    exclusive: bool = False
    reverse: bool = False
    KIND = "CumSum"

    def eval(self, inputs):
        x, axis = inputs
        ax = int(np.asarray(axis).reshape(())) % x.ndim
        from .common import downcast_result, upcast_for_compute

        xc, orig = upcast_for_compute(x)
        if self.reverse:
            xc = np.flip(xc, axis=ax)
        out = np.cumsum(xc, axis=ax)
        if self.exclusive:
            out = np.roll(out, 1, axis=ax)
            sl = [slice(None)] * x.ndim
            sl[ax] = slice(0, 1)
            out[tuple(sl)] = 0
        if self.reverse:
            out = np.flip(out, axis=ax)
        out = out.astype(xc.dtype, copy=False)
        return [downcast_result(out, orig)]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC and infos[1].level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value, infos[1].value])[0])]
        return [TensorInfo(i.dtype, min(i.level, Level.SHAPED), shape=i.shape, rank_=i.rank_)]


@dataclass
class TopK(MilliOp):
    axis: int = -1
    largest: bool = True
    sorted: bool = True
    KIND = "TopK"
    N_OUTPUTS = 2

    def eval(self, inputs):
        x, k = inputs
        kk = int(np.asarray(k).reshape(-1)[0])
        ax = self.axis % x.ndim
        from .common import upcast_for_compute

        xc, _ = upcast_for_compute(x)
        if xc.dtype.kind == "u":
            # unsigned negation wraps; order in float64 (exact <= 2^53)
            xc = xc.astype(np.float64)
        if self.largest:
            part = np.argsort(-xc, axis=ax, kind="stable")
        else:
            part = np.argsort(xc, axis=ax, kind="stable")
        idx = np.take(part, range(kk), axis=ax)
        vals = np.take_along_axis(x, idx, axis=ax)
        return [vals, idx.astype(np.int64)]


    def infer(self, infos):
        x, k = infos
        if x.level is Level.NUMERIC and k.level is Level.NUMERIC:
            v, i = self.eval([x.value, k.value])
            return [TensorInfo.numeric(v), TensorInfo.numeric(i)]
        dims = x.dims()
        if dims is not None and k.level is Level.NUMERIC:
            kk = int(np.asarray(k.value).reshape(-1)[0])
            ax = self.axis % len(dims)
            out = [ScalarInfo.of(kk) if j == ax else d for j, d in enumerate(dims)]
            return [TensorInfo.shaped(x.dtype, out), TensorInfo.shaped(DType.I64, out)]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank), TensorInfo.ranked(DType.I64, x.rank)]
        return [TensorInfo.minimal(x.dtype), TensorInfo.minimal(DType.I64)]


@dataclass
class NonZero(MilliOp):
    """Indices of nonzero elements, shape (rank, N). Data-dependent output
    shape: oracle-only (never jittable — graph-partition fallback)."""

    KIND = "NonZero"

    def eval(self, inputs):
        return [np.asarray(np.nonzero(inputs[0]), dtype=np.int64)]

    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        if i.rank is not None:
            return [TensorInfo(DType.I64, Level.RANKED, rank_=2)]
        return [TensorInfo.minimal(DType.I64)]


# -- lowerings ----------------------------------------------------------


def _keep_int(mode: str) -> bool:
    return mode in ("sum", "prod", "min", "max")


@lowering("Reduce")
def reduce_(op, inputs, static, device):
    x = inputs[0]
    axes_arr = (need_static(static, 1, "Reduce")
                if len(inputs) > 1 and inputs[1] is not None else None)
    ax = op._axes(x.ndim, axes_arr)
    if len(ax) == 0:
        return [x]
    if any(x.shape[a] == 0 for a in ax):
        host = np.zeros(tuple(x.shape), np_dtype(x.dtype))
        return [torch.from_numpy(op._empty_set(host, ax, np)).to(device)]
    m, kd = op.mode, op.keepdims
    is_int = not x.dtype.is_floating_point
    if is_int and m in ("min", "max"):
        k = order_key(x)
        r = k.amax(dim=ax, keepdim=kd) if m == "max" else \
            k.amin(dim=ax, keepdim=kd)
        return [from_order_key(r, x.dtype)]
    if is_int:
        # numpy: integer sums accumulate in int64; mean and the norms'
        # square roots in float64
        xc = widen(x).to(torch.float64 if m in ("mean", "l2", "logsumexp")
                         else torch.int64)
    else:
        xc = up(x)
    if m == "sum":
        out = xc.sum(dim=ax, keepdim=kd)
    elif m == "mean":
        out = xc.mean(dim=ax, keepdim=kd)
    elif m == "prod":
        out = xc
        for a in sorted(ax, reverse=True):
            out = out.prod(dim=a, keepdim=kd)
    elif m == "min":
        out = xc.amin(dim=ax, keepdim=kd)
    elif m == "max":
        out = xc.amax(dim=ax, keepdim=kd)
    elif m == "l2":
        out = (xc * xc).sum(dim=ax, keepdim=kd).sqrt()
    elif m == "l1":
        out = xc.abs().sum(dim=ax, keepdim=kd)
    elif m == "sumsquare":
        out = (xc * xc).sum(dim=ax, keepdim=kd)
    elif m == "logsumexp":
        out = torch.logsumexp(xc, dim=ax, keepdim=kd)
    else:
        raise NotImplementedError(f"Reduce mode {m}")
    if is_int:
        return [out.to(x.dtype) if _keep_int(m) else out]
    return [down(out, x.dtype)]


@lowering("ArgMinMax")
def arg_min_max(op, inputs, static, device):
    x = inputs[0]
    ax = op.axis % x.ndim
    xc = up(x) if x.dtype.is_floating_point else order_key(x)
    if op.select_last_index:
        xc = xc.flip(ax)
    idx = xc.argmax(dim=ax) if op.mode == "max" else xc.argmin(dim=ax)
    if op.select_last_index:
        idx = x.shape[ax] - 1 - idx
    if op.keepdims:
        idx = idx.unsqueeze(ax)
    return [idx.to(torch.int64)]


@lowering("CumSum")
def cum_sum(op, inputs, static, device):
    x = inputs[0]
    ax = int(need_static(static, 1, "CumSum").reshape(())) % x.ndim
    xc = widen(up(x))
    if op.reverse:
        xc = xc.flip(ax)
    out = torch.cumsum(xc, dim=ax, dtype=xc.dtype)
    if op.exclusive:
        zero = torch.zeros_like(out.narrow(ax, 0, 1))
        out = torch.cat([zero, out.narrow(ax, 0, out.shape[ax] - 1)], ax)
    if op.reverse:
        out = out.flip(ax)
    return [narrow(out, x.dtype)]


@lowering("TopK")
def top_k(op, inputs, static, device):
    x = inputs[0]
    kk = int(need_static(static, 1, "TopK").reshape(-1)[0])
    ax = op.axis % x.ndim
    key = up(x) if x.dtype.is_floating_point else order_key(x)
    # a stable sort keeps equal values in index order, as the oracle's
    # stable argsort does
    _, idx = torch.sort(key, dim=ax, descending=op.largest, stable=True)
    idx = idx.narrow(ax, 0, kk)
    return [narrow(torch.gather(widen(x), ax, idx), x.dtype),
            idx.to(torch.int64)]


@lowering("NonZero")
def non_zero(op, inputs, static, device):
    x = widen(inputs[0])
    if x.ndim == 0:
        x = x.reshape(1)
    return [torch.nonzero(x).T.contiguous().to(torch.int64)]
