"""Constant, Cast, CastLike, SimpleUnary, SimpleBinary, Where and MatMul
lowerings.

Counterparts of the `to_jax` methods in whisper_tensor_tpu/milli/ops/
basic.py. Oracle contract: bf16/f16 elementwise math computes in f32
and rounds back once; matmuls accumulate in f32 (bf16/f16 inputs) or in
their own type (f32, f64).
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tensor_tpu.dtype import DType

from ...dtype import from_torch, to_device, to_torch
from ..registry import lowering

_LOW = (torch.bfloat16, torch.float16)


@lowering("Constant")
def constant(op, inputs, static, device):
    return [to_device(np.asarray(op.value), device)]


@lowering("Cast")
def cast(op, inputs, static, device):
    return [inputs[0].to(to_torch(op.dtype))]


@lowering("CastLike")
def cast_like(op, inputs, static, device):
    return [inputs[0].to(inputs[1].dtype)]


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
    orig = x.dtype if x.dtype in _LOW else None
    if orig is not None:
        x = x.float()
    out = _UNARY[op.mode](x)
    if orig is not None and out.dtype == torch.float32:
        out = out.to(orig)
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


@lowering("SimpleBinary")
def simple_binary(op, inputs, static, device):
    a, c = inputs
    # numpy/jax promotion: a 0-d tensor is not "weaker" than a ranked one
    dt = torch.promote_types(a.dtype, c.dtype)
    a, c = a.to(dt), c.to(dt)
    m = op.mode
    if m == "div" and not (dt.is_floating_point or dt == torch.bool):
        return [torch.div(a, c, rounding_mode="trunc")]   # ONNX: toward 0
    if dt in _LOW:
        out = _BINARY[m](a.float(), c.float())
        return [out.to(dt) if out.dtype == torch.float32 else out]
    return [_BINARY[m](a, c)]


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
    if a.dtype in _LOW and acc is DType.F32 and out_dt == a.dtype:
        # cuBLAS accumulates bf16/f16 products in f32 with reduced-
        # precision reduction off (device.py): one rounding at the end
        return [torch.matmul(a, c.to(a.dtype))]
    acc_t = to_torch(acc)
    return [torch.matmul(a.to(acc_t), c.to(acc_t)).to(out_dt)]
