"""Normalization milli ops: LayerNorm, RMSNorm, InstanceNorm, GroupNorm,
BatchNorm, and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/norm.py
(numpy `eval`, shape inference and the autodiff `backward` rules; no
`to_jax`). The lowerings take statistics in f32 (the ONNX stash_type=1
default) and round the output back to the input type once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp, Phase
from ..registry import lowering


def _bcast_to_rank(v, ndim: int, axis: int):
    """reshape 1-D per-channel param for broadcasting at `axis`."""
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


@dataclass
class LayerNormMilli(MilliOp):
    """x, scale[, bias] -> y[, mean, inv_std]; normalizes dims [axis:].
    Mean/InvStdDev (keepdims over the normalized span) stay in the
    stash dtype (f32 when stash_f32), per the ONNX-17 spec."""

    axis: int = -1
    epsilon: float = 1e-5
    stash_f32: bool = True
    n_out: int = 1
    KIND = "LayerNorm"
    N_OUTPUTS = 1

    def _stats(self, xp, ax):
        mean = xp.mean(axis=ax, keepdims=True)
        d = xp - mean
        var = (d * d).mean(axis=ax, keepdims=True)
        return mean, d, var

    def eval(self, inputs):
        x = inputs[0]
        scale = inputs[1]
        bias = inputs[2] if len(inputs) > 2 and inputs[2] is not None else None
        ax = tuple(range(self.axis % x.ndim, x.ndim))
        xp = x.astype(np.float32) if self.stash_f32 and x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        mean, d, var = self._stats(xp, ax)
        inv = 1.0 / np.sqrt(var + np.asarray(self.epsilon, dtype=xp.dtype))
        y = d * inv * scale.astype(xp.dtype)
        if bias is not None:
            y = y + bias.astype(xp.dtype)
        stash_dt = np.float32 if self.stash_f32 else x.dtype
        return [y.astype(x.dtype), mean.astype(stash_dt),
                inv.astype(stash_dt)][:self.n_out]


    def infer(self, infos):
        i = infos[0]
        if all(f is not None and f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(o)
                    for o in self.eval([f.value for f in infos])]
        if self.n_out == 1:
            return [i.forget_value()]
        from ...dtype import DType
        stash = DType.F32 if self.stash_f32 else i.dtype
        stats = (TensorInfo.ranked(stash, i.rank) if i.rank is not None
                 else TensorInfo.minimal(stash))
        return [i.forget_value(), stats, stats][:self.n_out]

    def backward(self, b, node, out_grads):
        """Recompute-based LN backward:
          x̂ = (x-μ)·inv,  ĝ = g·γ
          dx = inv·(ĝ − mean(ĝ) − x̂·mean(ĝ·x̂))   over normalized axes
          dγ = Σ_batch g·x̂,   dβ = Σ_batch g
        Needs the input rank (to span axis..rank); stats recomputed in
        the graph (cheap — XLA fuses them with the forward's)."""
        g = out_grads[0]
        if any(og is not None for og in out_grads[1:]):
            raise NotImplementedError(
                "LayerNorm backward: grads into Mean/InvStdDev outputs")
        if g is None:
            return [None] * len(node.inputs)
        from .basic import Constant, SimpleBinary, SimpleUnary
        from .reduce import Reduce

        x, scale = node.inputs[0], node.inputs[1]
        has_bias = len(node.inputs) > 2 and node.inputs[2] is not None
        info = b.tensors[x].info
        rank = info.rank if info is not None else None
        if rank is None:
            raise NotImplementedError("LayerNorm backward: unknown rank")
        ax = self.axis % rank
        norm_axes = list(range(ax, rank))
        batch_axes = list(range(0, ax))
        P = Phase.BACKWARD

        def bop(mode, *ins):
            return b.op1(SimpleBinary(mode), *ins, phase=P)

        mean = b.op1(Reduce("mean", norm_axes, keepdims=True), x, phase=P)
        d = bop("sub", x, mean)
        var = b.op1(Reduce("mean", norm_axes, keepdims=True),
                    bop("mul", d, d), phase=P)
        eps = b.op1(Constant(np.asarray(self.epsilon, dtype=np.float32)),
                    phase=P)
        from .basic import CastLike

        epsc = b.op1(CastLike(), eps, var, phase=P)
        inv = bop("div",
                  b.op1(CastLike(), b.op1(Constant(
                      np.asarray(1.0, dtype=np.float32)), phase=P), var,
                      phase=P),
                  b.op1(SimpleUnary("sqrt"), bop("add", var, epsc), phase=P))
        xhat = bop("mul", d, inv)
        ghat = bop("mul", g, scale)
        m1 = b.op1(Reduce("mean", norm_axes, keepdims=True), ghat, phase=P)
        m2 = b.op1(Reduce("mean", norm_axes, keepdims=True),
                   bop("mul", ghat, xhat), phase=P)
        dx = bop("mul", inv, bop("sub", bop("sub", ghat, m1),
                                 bop("mul", xhat, m2)))
        gx = bop("mul", g, xhat)
        if batch_axes:
            dscale = b.op1(Reduce("sum", batch_axes, keepdims=False), gx,
                           phase=P)
            dbias = (b.op1(Reduce("sum", batch_axes, keepdims=False), g,
                           phase=P) if has_bias else None)
        else:
            dscale = gx
            dbias = g if has_bias else None
        out = [dx, dscale]
        if len(node.inputs) > 2:
            out.append(dbias)
        return out


@dataclass
class RMSNormMilli(MilliOp):
    axis: int = -1
    epsilon: float = 1e-5
    stash_f32: bool = True
    KIND = "RMSNorm"

    def eval(self, inputs):
        x, scale = inputs[0], inputs[1]
        ax = tuple(range(self.axis % x.ndim, x.ndim))
        xp = x.astype(np.float32) if self.stash_f32 and x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        ms = (xp * xp).mean(axis=ax, keepdims=True)
        y = xp / np.sqrt(ms + np.asarray(self.epsilon, dtype=xp.dtype))
        return [(y * scale.astype(xp.dtype)).astype(x.dtype)]


    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]


@dataclass
class InstanceNormMilli(MilliOp):
    """x(N,C,*sp), scale(C), bias(C): normalize each (n,c) over spatial."""

    epsilon: float = 1e-5
    KIND = "InstanceNorm"

    def eval(self, inputs):
        x, scale, bias = inputs
        ax = tuple(range(2, x.ndim))
        xp = x.astype(np.float32) if x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        mean = xp.mean(axis=ax, keepdims=True)
        d = xp - mean
        var = (d * d).mean(axis=ax, keepdims=True)
        y = d / np.sqrt(var + np.asarray(self.epsilon, dtype=xp.dtype))
        y = y * _bcast_to_rank(scale.astype(xp.dtype), x.ndim, 1) \
            + _bcast_to_rank(bias.astype(xp.dtype), x.ndim, 1)
        return [y.astype(x.dtype)]


    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]


@dataclass
class GroupNormMilli(MilliOp):
    """x(N,C,*sp), scale(C), bias(C); normalize per group of channels."""

    epsilon: float = 1e-5
    num_groups: int = 1
    KIND = "GroupNorm"

    def eval(self, inputs):
        x, scale, bias = inputs
        N, C = x.shape[0], x.shape[1]
        sp = x.shape[2:]
        gdim = self.num_groups
        xp = x.astype(np.float32) if x.dtype.kind == "f" and x.dtype.itemsize < 4 else x
        xg = xp.reshape(N, gdim, C // gdim, *sp)
        ax = tuple(range(2, xg.ndim))
        mean = xg.mean(axis=ax, keepdims=True)
        d = xg - mean
        var = (d * d).mean(axis=ax, keepdims=True)
        y = (d / np.sqrt(var + np.asarray(self.epsilon, dtype=xp.dtype))).reshape(x.shape)
        y = y * _bcast_to_rank(scale.astype(xp.dtype), x.ndim, 1) \
            + _bcast_to_rank(bias.astype(xp.dtype), x.ndim, 1)
        return [y.astype(x.dtype)]


    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]

    def backward(self, b, node, out_grads):
        """Per-group LayerNorm backward in the grouped view:
          x̂ = (x−μ_g)·inv_g,  ĝ = g·γ_c
          dx = inv·(ĝ − mean_g(ĝ) − x̂·mean_g(ĝ·x̂))
          dγ_c = Σ_{N,spatial} g·x̂,   dβ_c = Σ_{N,spatial} g
        Needs a concrete input shape (group reshape), like the
        reference's shape-resolved norm backward rules."""
        g = out_grads[0]
        if g is None:
            return [None, None, None]
        from .basic import CastLike, Constant, SimpleBinary, SimpleUnary
        from .reduce import Reduce
        from .shape import Reshape

        x, scale = node.inputs[0], node.inputs[1]
        info = b.tensors[x].info
        dims = info.dims() if info is not None else None
        if dims is None or any(d is None or not d.is_known for d in dims):
            raise NotImplementedError("GroupNorm backward: unknown shape")
        shape = [int(d.value()) for d in dims]
        N, C, sp = shape[0], shape[1], shape[2:]
        G = self.num_groups
        gshape = [N, G, C // G] + sp
        P = Phase.BACKWARD

        def bop(mode, *ins):
            return b.op1(SimpleBinary(mode), *ins, phase=P)

        def const_i64(vals):
            return b.op1(Constant(np.asarray(vals, dtype=np.int64)),
                         phase=P)

        def reshape(t, spec):
            return b.op1(Reshape(), t, const_i64(spec), phase=P)

        norm_axes = list(range(2, len(gshape)))
        xg = reshape(x, gshape)
        mean = b.op1(Reduce("mean", norm_axes, keepdims=True), xg, phase=P)
        d = bop("sub", xg, mean)
        var = b.op1(Reduce("mean", norm_axes, keepdims=True),
                    bop("mul", d, d), phase=P)
        eps = b.op1(CastLike(), b.op1(Constant(
            np.asarray(self.epsilon, dtype=np.float32)), phase=P), var,
            phase=P)
        one = b.op1(CastLike(), b.op1(Constant(
            np.asarray(1.0, dtype=np.float32)), phase=P), var, phase=P)
        inv = bop("div", one,
                  b.op1(SimpleUnary("sqrt"), bop("add", var, eps), phase=P))
        xhat = bop("mul", d, inv)

        # ĝ = g·γ broadcast per channel (axis 1), then grouped
        sc_view = reshape(b.op1(CastLike(), scale, g, phase=P),
                          [1, C] + [1] * len(sp))
        ghat = reshape(bop("mul", g, sc_view), gshape)
        m1 = b.op1(Reduce("mean", norm_axes, keepdims=True), ghat, phase=P)
        m2 = b.op1(Reduce("mean", norm_axes, keepdims=True),
                   bop("mul", ghat, xhat), phase=P)
        dx = reshape(bop("mul", inv, bop("sub", bop("sub", ghat, m1),
                                         bop("mul", xhat, m2))), shape)

        red_axes = [0] + list(range(2, len(shape)))   # all but channel
        gx = bop("mul", g, reshape(xhat, shape))
        dscale = b.op1(Reduce("sum", red_axes, keepdims=False), gx, phase=P)
        dbias = b.op1(Reduce("sum", red_axes, keepdims=False), g, phase=P)
        return [dx, dscale, dbias]


@dataclass
class BatchNormMilli(MilliOp):
    """Batch norm: x, scale, bias, mean, var (all per-C). training=True
    normalizes with CURRENT batch stats and also returns the
    momentum-blended running mean/var (ONNX-15 outputs)."""

    epsilon: float = 1e-5
    training: bool = False
    momentum: float = 0.9
    n_out: int = 1
    KIND = "BatchNorm"

    def _norm(self, xp_mod, x, scale, bias, mean, var, cur_axes):
        f32 = np.float32
        xp = x.astype(f32)
        r = x.ndim
        if self.training:
            cur_mean = xp.mean(axis=cur_axes)
            cur_var = ((xp - _bcast_to_rank(cur_mean, r, 1)) ** 2).mean(
                axis=cur_axes)
            use_mean, use_var = cur_mean, cur_var
            run_mean = (mean.astype(f32) * self.momentum
                        + cur_mean * (1.0 - self.momentum))
            run_var = (var.astype(f32) * self.momentum
                       + cur_var * (1.0 - self.momentum))
        else:
            use_mean, use_var = mean.astype(f32), var.astype(f32)
            run_mean = run_var = None
        inv = 1.0 / np.sqrt(use_var + np.float32(self.epsilon))
        y = (xp - _bcast_to_rank(use_mean, r, 1)) \
            * _bcast_to_rank(inv, r, 1)
        y = y * _bcast_to_rank(scale.astype(f32), r, 1) \
            + _bcast_to_rank(bias.astype(f32), r, 1)
        return y, run_mean, run_var

    def eval(self, inputs):
        x, scale, bias, mean, var = inputs
        axes = tuple(a for a in range(x.ndim) if a != 1)
        y, rm, rv = self._norm(np, x, scale, bias, mean, var, axes)
        outs = [y.astype(x.dtype)]
        if self.n_out >= 2:
            outs.append(rm.astype(mean.dtype))
        if self.n_out >= 3:
            outs.append(rv.astype(var.dtype))
        return outs


    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(o)
                    for o in self.eval([f.value for f in infos])]
        return [i.forget_value(), infos[3].forget_value(),
                infos[4].forget_value()][:self.n_out]


# -- lowerings ----------------------------------------------------------


@lowering("RMSNorm")
def rms_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    ms = (xp * xp).mean(dim=dims, keepdim=True)
    y = xp * torch.rsqrt(ms + op.epsilon)
    return [(y * scale.to(xp.dtype)).to(x.dtype)]


@lowering("LayerNorm")
def layer_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    bias = inputs[2] if len(inputs) > 2 else None
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    mean = xp.mean(dim=dims, keepdim=True)
    d = xp - mean
    inv = torch.rsqrt((d * d).mean(dim=dims, keepdim=True) + op.epsilon)
    y = d * inv * scale.to(xp.dtype)
    if bias is not None:
        y = y + bias.to(xp.dtype)
    stash = torch.float32 if op.stash_f32 else x.dtype
    return [y.to(x.dtype), mean.to(stash), inv.to(stash)][:op.n_out]


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) parameter shaped to broadcast at axis 1 of a rank-ndim x."""
    return v.reshape([1, -1] + [1] * (ndim - 2))


def _f32(x: torch.Tensor) -> torch.Tensor:
    # the oracle stashes low floats in f32 and keeps f32/f64 as they are
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@lowering("InstanceNorm")
def instance_norm(op, inputs, static, device):
    x, scale, bias = inputs
    dims = tuple(range(2, x.ndim))
    xp = _f32(x)
    d = xp - xp.mean(dim=dims, keepdim=True)
    var = (d * d).mean(dim=dims, keepdim=True)
    y = d * torch.rsqrt(var + op.epsilon)
    y = y * _per_channel(scale.to(xp.dtype), x.ndim) \
        + _per_channel(bias.to(xp.dtype), x.ndim)
    return [y.to(x.dtype)]


@lowering("GroupNorm")
def group_norm(op, inputs, static, device):
    x, scale, bias = inputs
    n, c = x.shape[0], x.shape[1]
    xp = _f32(x)
    xg = xp.reshape(n, op.num_groups, c // op.num_groups, *x.shape[2:])
    dims = tuple(range(2, xg.ndim))
    d = xg - xg.mean(dim=dims, keepdim=True)
    var = (d * d).mean(dim=dims, keepdim=True)
    y = (d * torch.rsqrt(var + op.epsilon)).reshape(x.shape)
    y = y * _per_channel(scale.to(xp.dtype), x.ndim) \
        + _per_channel(bias.to(xp.dtype), x.ndim)
    return [y.to(x.dtype)]


@lowering("BatchNorm")
def batch_norm(op, inputs, static, device):
    x, scale, bias, mean, var = inputs
    r = x.ndim
    xp = x.float()
    if op.training:
        dims = tuple(a for a in range(r) if a != 1)
        use_mean = xp.mean(dim=dims)
        use_var = ((xp - _per_channel(use_mean, r)) ** 2).mean(dim=dims)
        run_mean = mean.float() * op.momentum + use_mean * (1 - op.momentum)
        run_var = var.float() * op.momentum + use_var * (1 - op.momentum)
    else:
        use_mean, use_var = mean.float(), var.float()
        run_mean = run_var = None
    inv = 1.0 / torch.sqrt(use_var + np.float32(op.epsilon))
    y = (xp - _per_channel(use_mean, r)) * _per_channel(inv, r)
    y = y * _per_channel(scale.float(), r) + _per_channel(bias.float(), r)
    outs = [y.to(x.dtype)]
    if op.n_out >= 2:
        outs.append(run_mean.to(mean.dtype))
    if op.n_out >= 3:
        outs.append(run_var.to(var.dtype))
    return outs
