"""Core milli ops: constants, casts, unary/binary elementwise, Pow,
ClampMin, Where and MatMul, and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/basic.py
(numpy `eval` and shape inference; no `to_jax` and no autodiff
`backward`). Oracle contract: bf16/f16/f8 elementwise math computes in
f32 and rounds back once; matmuls accumulate in f32 (bf16/f16/f8 inputs)
or in their own type (f32, f64, ints). Casts follow the oracle's numpy
`astype`: a float8 cast out of range gives NaN (e4m3fn) or inf (e5m2),
where torch's own conversion would saturate, and a 4-bit float rounds to
nearest-even and saturates at 6 (ml_dtypes). The unsigned wide types
compute widened (lowering_common.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from ...dtype import (F4E2M1_VALUES, DType, from_torch, to_device,
                      to_torch)
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering, need_static
from .common import (binary_compute, elementwise_infer, unary_compute,
                     upcast_for_compute)
from .lowering_common import (LOW_FLOATS, WIDE_UNSIGNED, down,
                              from_order_key, narrow, order_key, up, widen)


# ---------------------------------------------------------------------------
@dataclass
class Constant(MilliOp):
    """Embedded constant value."""

    value: np.ndarray = None  # type: ignore[assignment]
    KIND = "Constant"

    def eval(self, inputs):
        return [np.asarray(self.value)]


    def infer(self, infos):
        return [TensorInfo.numeric(np.asarray(self.value))]

    def properties(self):
        v = np.asarray(self.value)
        return {"dtype": str(v.dtype), "shape": list(v.shape)}


@dataclass
class ConstantOfShape(MilliOp):
    """Fill tensor of runtime shape (input 0 = 1-D i64 shape)."""

    value: np.ndarray = None  # scalar fill, carries dtype
    KIND = "ConstantOfShape"

    def eval(self, inputs):
        shape = tuple(int(x) for x in np.asarray(inputs[0]).reshape(-1))
        fill = np.asarray(self.value).reshape(())
        return [np.full(shape, fill, dtype=fill.dtype)]


    def infer(self, infos):
        fill = np.asarray(self.value).reshape(())
        dt = DType.from_numpy(fill.dtype)
        si = infos[0]
        if si.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([si.value])[0])]
        if si.dims() is not None and si.dims()[0].is_known:
            return [TensorInfo.ranked(dt, int(si.dims()[0].value()))]
        return [TensorInfo.minimal(dt)]


@dataclass
class Cast(MilliOp):
    dtype: DType = DType.F32
    KIND = "Cast"

    def eval(self, inputs):
        x = inputs[0]
        if self.dtype is DType.STRING:
            return [np.asarray(x).astype(str).astype(object)]
        if x.dtype == np.dtype(object) or x.dtype.kind in ("U", "S"):
            tgt = self.dtype.to_numpy()
            return [np.asarray(x).astype(np.float64 if self.dtype.is_float else np.int64).astype(tgt)]
        if self.dtype is DType.BOOL:
            return [np.asarray(x).astype(np.bool_)]
        return [np.asarray(x).astype(self.dtype.to_numpy())]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0], self.dtype)]
        return [TensorInfo(self.dtype, i.level, shape=i.shape, rank_=i.rank_)]


@dataclass
class CastLike(MilliOp):
    """Cast input 0 to the dtype of input 1."""

    KIND = "CastLike"

    def eval(self, inputs):
        return [np.asarray(inputs[0]).astype(inputs[1].dtype)]


    def infer(self, infos):
        x, like = infos
        dt = like.dtype
        if x.level is Level.NUMERIC:
            return [TensorInfo.numeric(x.value.astype(dt.to_numpy()), dt)]
        return [TensorInfo(dt, x.level, shape=x.shape, rank_=x.rank_)]


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------


def _np_erf(x: np.ndarray) -> np.ndarray:
    # torch is the oracle for special functions (baked-in, CPU);
    # ascontiguousarray promotes 0-d to (1,), so restore the shape
    import torch

    out = torch.erf(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    return out.reshape(np.shape(x))


def _np_round(x):
    return np.round(x)  # half-to-even, matches ONNX Round


_UNARY_TABLE = {
    # mode: (numpy_fn, jax_name, bool_out)
    "neg": (lambda x: -x, "negative", False),
    "abs": (np.abs, "abs", False),
    "exp": (np.exp, "exp", False),
    "log": (np.log, "log", False),
    "sqrt": (np.sqrt, "sqrt", False),
    "sin": (np.sin, "sin", False),
    "cos": (np.cos, "cos", False),
    "tan": (np.tan, "tan", False),
    "asin": (np.arcsin, "arcsin", False),
    "acos": (np.arccos, "arccos", False),
    "atan": (np.arctan, "arctan", False),
    "sinh": (np.sinh, "sinh", False),
    "cosh": (np.cosh, "cosh", False),
    "tanh": (np.tanh, "tanh", False),
    "asinh": (np.arcsinh, "arcsinh", False),
    "acosh": (np.arccosh, "arccosh", False),
    "atanh": (np.arctanh, "arctanh", False),
    "sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)), "_sigmoid", False),
    "erf": (_np_erf, "_erf", False),
    "floor": (np.floor, "floor", False),
    "ceil": (np.ceil, "ceil", False),
    "round": (_np_round, "round", False),
    "reciprocal": (lambda x: 1.0 / x, "_reciprocal", False),
    "not": (np.logical_not, "logical_not", True),
    "bitnot": (np.invert, "invert", False),
    "sign": (np.sign, "sign", False),
    "relu": (lambda x: np.maximum(x, 0), "_relu", False),
    "isnan": (np.isnan, "isnan", True),
    "softplus": (lambda x: np.logaddexp(x, 0.0), "_softplus", False),
}


@dataclass
class SimpleUnary(MilliOp):
    mode: str = "neg"
    KIND = "SimpleUnary"

    def eval(self, inputs):
        fn, _, bool_out = _UNARY_TABLE[self.mode]
        x = inputs[0]
        if self.mode in ("not",):
            return [np.logical_not(x)]
        if x.dtype.kind in "iub" and self.mode in ("neg", "abs", "sign",
                                                   "bitnot"):
            return [fn(x)]
        if bool_out:
            # isnan etc.: BOOL result — never round back to the input
            # dtype (the f32-compute contract applies to float outputs)
            from .common import upcast_for_compute

            return [fn(upcast_for_compute(x)[0]).astype(np.bool_)]
        return [unary_compute(x, fn)]


    def infer(self, infos):
        i = infos[0]
        bool_out = _UNARY_TABLE[self.mode][2]
        dt = DType.BOOL if bool_out else i.dtype
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0], dt)]
        return [TensorInfo(dt, min(i.level, Level.SHAPED), shape=i.shape, rank_=i.rank_)]


# ---------------------------------------------------------------------------
# binary
# ---------------------------------------------------------------------------

_BOOL_MODES = ("eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor")


@dataclass
class SimpleBinary(MilliOp):
    mode: str = "add"
    KIND = "SimpleBinary"

    def eval(self, inputs):
        a, c = inputs
        m = self.mode
        if m == "add":
            return [binary_compute(a, c, np.add)]
        if m == "sub":
            return [binary_compute(a, c, np.subtract)]
        if m == "mul":
            return [binary_compute(a, c, np.multiply)]
        if m == "div":
            if a.dtype.kind == "u":
                return [a // c]
            if a.dtype.kind == "i":  # ONNX integer Div truncates toward zero
                q = (np.abs(a) // np.abs(c)) * (np.sign(a) * np.sign(c))
                return [q.astype(a.dtype)]
            return [binary_compute(a, c, np.divide)]
        if m == "mod":  # fmod=0: sign of divisor (python %)
            return [binary_compute(a, c, np.mod)]
        if m == "fmod":
            return [binary_compute(a, c, np.fmod)]
        if m == "max":
            return [binary_compute(a, c, np.maximum)]
        if m == "min":
            return [binary_compute(a, c, np.minimum)]
        if m == "and":
            return [np.logical_and(a, c)]
        if m == "or":
            return [np.logical_or(a, c)]
        if m == "xor":
            return [np.logical_xor(a, c)]
        if m == "bitand":
            return [np.bitwise_and(a, c)]
        if m == "bitor":
            return [np.bitwise_or(a, c)]
        if m == "bitxor":
            return [np.bitwise_xor(a, c)]
        if m == "bitshift_left":
            return [np.left_shift(a, c)]
        if m == "bitshift_right":
            return [np.right_shift(a, c)]
        if m in _BOOL_MODES:
            fn = {"eq": np.equal, "ne": np.not_equal, "lt": np.less, "le": np.less_equal,
                  "gt": np.greater, "ge": np.greater_equal}[m]
            return [binary_compute(a, c, fn, bool_out=True)]
        raise NotImplementedError(m)


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            out = self.eval([i.value for i in infos])[0]
            return [TensorInfo.numeric(out)]
        dt = DType.BOOL if self.mode in _BOOL_MODES else None
        return [elementwise_infer(infos, out_dtype=dt)]


@dataclass
class Pow(MilliOp):
    KIND = "Pow"

    def eval(self, inputs):
        a, c = inputs
        xa, oa = upcast_for_compute(a)
        xc, _ = upcast_for_compute(c)
        out = np.power(xa, xc.astype(xa.dtype) if xa.dtype.kind == "f" else xc)
        from .common import downcast_result

        return [downcast_result(out.astype(xa.dtype), oa)]


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [elementwise_infer([infos[0], TensorInfo(infos[0].dtype, infos[1].level,
                                                        shape=infos[1].shape, rank_=infos[1].rank_)])]


@dataclass
class ClampMin(MilliOp):
    """Elementwise max with a scalar (used by clip lowering and norms)."""

    value: float = 0.0
    KIND = "ClampMin"

    def eval(self, inputs):
        x = inputs[0]
        return [unary_compute(x, lambda v: np.maximum(v, np.asarray(self.value, dtype=v.dtype)))]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [i]


@dataclass
class Where(MilliOp):
    """Select(cond, a, b)."""

    KIND = "Where"

    def eval(self, inputs):
        cond, a, c = inputs
        return [np.where(cond, a, c).astype(np.result_type(a, c) if a.dtype != c.dtype else a.dtype)]


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        dt = infos[1].dtype
        return [elementwise_infer(infos, out_dtype=dt)]


# ---------------------------------------------------------------------------
# matmul with explicit accumulate dtype
# ---------------------------------------------------------------------------


@dataclass
class MatMul(MilliOp):
    """Batched matmul (numpy semantics) with explicit accumulation dtype.

    Reference: src/milli_graph/ops/binary.rs:530-620 — bf16/f16 inputs
    accumulate in f32. On TPU this maps to the MXU's native f32
    accumulator via preferred_element_type (or the Pallas matmul kernel).
    """

    accumulate: Optional[DType] = None  # None = dtype-default
    out_dtype: Optional[DType] = None   # None = input dtype
    KIND = "MatMul"

    def _acc(self, in_dt: DType) -> DType:
        return self.accumulate or in_dt.accumulate_dtype()

    def eval(self, inputs):
        a, c = inputs
        in_dt = DType.from_numpy(a.dtype)
        acc = self._acc(in_dt)
        out_dt = self.out_dtype or in_dt
        an = a.astype(acc.to_numpy(), copy=False)
        cn = c.astype(acc.to_numpy(), copy=False)
        out = np.matmul(an, cn)
        return [out.astype(out_dt.to_numpy(), copy=False)]


    def infer(self, infos):
        a, c = infos
        out_dt = self.out_dtype or a.dtype
        if a.level is Level.NUMERIC and c.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([a.value, c.value])[0], out_dt)]
        da, dc = a.dims(), c.dims()
        if da is not None and dc is not None:
            from ...scalar_info import ScalarInfo

            da, dc = list(da), list(dc)
            squeeze_a = squeeze_c = False
            if len(da) == 1:
                da = [ScalarInfo.of(1)] + da
                squeeze_a = True
            if len(dc) == 1:
                dc = dc + [ScalarInfo.of(1)]
                squeeze_c = True
            from .common import broadcast_dims

            batch = broadcast_dims(da[:-2], dc[:-2])
            if batch is not None:
                dims = batch + [da[-2], dc[-1]]
                if squeeze_a:
                    dims.pop(-2)
                if squeeze_c:
                    dims.pop(-1)
                return [TensorInfo.shaped(out_dt, dims)]
        if a.rank is not None and c.rank is not None:
            return [TensorInfo.ranked(out_dt, max(a.rank, c.rank))]
        return [TensorInfo.minimal(out_dt)]


# -- lowerings ----------------------------------------------------------


@lowering("Constant")
def constant(op, inputs, static, device):
    return [to_device(np.asarray(op.value), device)]


@lowering("ConstantOfShape")
def constant_of_shape(op, inputs, static, device):
    shape = need_static(static, 0, "ConstantOfShape")
    return [to_device(op.eval([shape])[0], device)]


# overflow of a float8 cast, as numpy/ml_dtypes rounds it: past the
# largest finite value's rounding interval, e4m3fn gives NaN and e5m2 inf
_F8_LIMIT = {torch.float8_e4m3fn: (464.0, float("nan")),
             torch.float8_e5m2: (61440.0, float("inf"))}
# 4-bit float: the rounding midpoints between its non-negative values
_F4_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def cast_to(x: torch.Tensor, dt: DType) -> torch.Tensor:
    """x cast to DType dt with the oracle's (numpy astype) semantics."""
    want = to_torch(dt)
    if dt is DType.F4E2M1:
        return _to_f4e2m1(x)
    if want in _F8_LIMIT and x.dtype != want:
        xf = up(x).float()
        lim, over = _F8_LIMIT[want]
        out = xf.to(want)
        bad = xf.abs() >= lim if over == float("inf") else xf.abs() > lim
        if want == torch.float8_e4m3fn:
            bad = bad | xf.isinf()
        fill = torch.full_like(xf, over).copysign(xf).to(want)
        return torch.where(bad, fill, out)
    if x.dtype in WIDE_UNSIGNED and want != x.dtype:
        return widen(x).to(want)
    if want in WIDE_UNSIGNED and x.dtype.is_floating_point:
        return narrow(x.to(torch.float64).to(torch.int64), want)
    if x.dtype in LOW_FLOATS[2:] and want != x.dtype:
        return x.float().to(want)
    return x.to(want)


def _to_f4e2m1(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest 4-bit E2M1 value (ties to even, saturating
    at 6, NaN to -0 as ml_dtypes does), in its f32 carrier."""
    xf = up(x).float()
    a = xf.abs().nan_to_num(nan=0.0)
    mids = torch.tensor(_F4_MIDPOINTS, device=x.device)
    code = torch.bucketize(a, mids)          # a == mid -> the lower code
    tie = (code < 7) & (a == mids[code.clamp(max=6)])
    code = torch.where(tie & (code % 2 == 1), code + 1, code)
    vals = torch.tensor(F4E2M1_VALUES[:8], device=x.device)[code]
    neg = xf.signbit() | xf.isnan()
    return torch.where(neg, -vals, vals)


@lowering("Cast")
def cast(op, inputs, static, device):
    return [cast_to(inputs[0], op.dtype)]


@lowering("CastLike")
def cast_like(op, inputs, static, device):
    return [cast_to(inputs[0], from_torch(inputs[1].dtype))]


_UNARY = {
    "neg": torch.neg, "abs": torch.abs, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "asinh": torch.asinh,
    "acosh": torch.acosh, "atanh": torch.atanh,
    "sigmoid": torch.sigmoid, "erf": torch.erf, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round,   # half to even, as ONNX
    "reciprocal": torch.reciprocal, "not": torch.logical_not,
    "bitnot": torch.bitwise_not, "sign": torch.sign, "relu": torch.relu,
    "isnan": torch.isnan,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
}


@lowering("SimpleUnary")
def simple_unary(op, inputs, static, device):
    x = inputs[0]
    if x.dtype in WIDE_UNSIGNED:
        return [narrow(_UNARY[op.mode](widen(x)), x.dtype)]
    out = _UNARY[op.mode](up(x))
    if out.dtype == torch.float32 and x.dtype in LOW_FLOATS:
        out = out.to(x.dtype)
    return [out]


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "mod": torch.remainder, "fmod": torch.fmod,
    "max": torch.maximum, "min": torch.minimum,
    "and": torch.logical_and, "or": torch.logical_or,
    "xor": torch.logical_xor, "bitand": torch.bitwise_and,
    "bitor": torch.bitwise_or, "bitxor": torch.bitwise_xor,
    "bitshift_left": torch.bitwise_left_shift,
    "bitshift_right": torch.bitwise_right_shift,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}
_ORDERED = ("max", "min", "eq", "ne", "lt", "le", "gt", "ge")


@lowering("SimpleBinary")
def simple_binary(op, inputs, static, device):
    a, c = inputs
    # numpy/jax promotion: a 0-d tensor is not "weaker" than a ranked one
    dt = torch.promote_types(a.dtype, c.dtype)
    a, c = a.to(dt), c.to(dt)
    m = op.mode
    if dt in WIDE_UNSIGNED:
        if m in _ORDERED:
            out = _BINARY[m](order_key(a), order_key(c))
            return [out if out.dtype == torch.bool
                    else from_order_key(out, dt)]
        wa, wc = widen(a), widen(c)
        out = (torch.div(wa, wc, rounding_mode="trunc") if m == "div"
               else _BINARY[m](wa, wc))
        return [out if out.dtype == torch.bool else narrow(out, dt)]
    if m == "div" and not (dt.is_floating_point or dt == torch.bool):
        return [torch.div(a, c, rounding_mode="trunc")]   # ONNX: toward 0
    if dt in LOW_FLOATS:
        out = _BINARY[m](a.float(), c.float())
        return [out.to(dt) if out.dtype == torch.float32 else out]
    return [_BINARY[m](a, c)]


@lowering("Pow")
def pow_(op, inputs, static, device):
    a, c = inputs
    xa, xc = up(widen(a)), up(widen(c))
    if xa.is_floating_point():
        out = torch.pow(xa, xc.to(xa.dtype))
    elif xc.is_floating_point():
        out = torch.pow(xa.to(torch.float64), xc.to(torch.float64))
    else:
        out = torch.pow(xa, xc)
    return [narrow(out.to(xa.dtype), a.dtype)]


@lowering("ClampMin")
def clamp_min(op, inputs, static, device):
    x = inputs[0]
    xc = up(x)
    floor = torch.tensor(np.asarray(op.value, dtype=np.dtype(
        str(xc.dtype).replace("torch.", ""))).item(), dtype=xc.dtype,
        device=x.device)
    return [down(torch.maximum(xc, floor), x.dtype)]


@lowering("Where")
def where(op, inputs, static, device):
    cond, a, c = inputs
    dt = torch.promote_types(a.dtype, c.dtype)   # numpy/jax promotion
    return [torch.where(cond.bool(), a.to(dt), c.to(dt))]


@lowering("MatMul")
def matmul(op, inputs, static, device):
    a, c = inputs
    in_dt = from_torch(a.dtype)
    acc = op.accumulate or in_dt.accumulate_dtype()
    out_dt = to_torch(op.out_dtype or in_dt)
    if a.dtype in LOW_FLOATS[:2] and acc is DType.F32 \
            and out_dt == a.dtype:
        # cuBLAS accumulates bf16/f16 products in f32 with reduced-
        # precision reduction off (device.py): one rounding at the end
        return [torch.matmul(a, c.to(a.dtype))]
    acc_t = to_torch(acc)
    if not acc_t.is_floating_point and a.device.type == "cuda":
        # cuBLAS has no integer GEMM: f64 is exact for these products
        # while every partial sum stays below 2**53
        return [torch.matmul(widen(a).to(torch.float64),
                             widen(c).to(torch.float64)).to(acc_t)
                .to(out_dt)]
    return [torch.matmul(widen(a).to(acc_t), widen(c).to(acc_t)).to(out_dt)]
