"""Indexing milli ops: the Gather family, ScatterND, ScatterElements,
Range, and their PyTorch lowerings.

The classes are the port's copy of whisper_tensor_tpu/milli/ops/index.py
(numpy `eval`, shape inference and the autodiff `backward` rules; no
`to_jax`), GatherGrad (the training-only gradient of Gather, lowered by
`index_add_`) among them. Scatters write into a copy of `data`;
an N-d index becomes one linear index over the indexed leading dims, so
every scatter is one `index_*` or `scatter_reduce` call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp, Phase
from ..registry import lowering, need_static
from .lowering_common import narrow, widen


@dataclass
class Gather(MilliOp):
    """ONNX Gather: index axis `axis` of data with arbitrary-rank indices."""

    axis: int = 0
    KIND = "Gather"

    def eval(self, inputs):
        data, idx = inputs
        ax = self.axis % data.ndim
        idx = idx.astype(np.int64)
        idx = np.where(idx < 0, idx + data.shape[ax], idx)
        return [np.take(data, idx, axis=ax)]


    def infer(self, infos):
        data, idx = infos
        if data.level is Level.NUMERIC and idx.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([data.value, idx.value])[0])]
        dd, di = data.dims(), idx.dims()
        if dd is not None and di is not None:
            ax = self.axis % len(dd)
            out = list(dd[:ax]) + list(di) + list(dd[ax + 1:])
            return [TensorInfo.shaped(data.dtype, out)]
        if data.rank is not None and idx.rank is not None:
            return [TensorInfo.ranked(data.dtype, data.rank - 1 + idx.rank)]
        return [TensorInfo.minimal(data.dtype)]

    def backward(self, b, node, out_grads):
        g = out_grads[0]
        if g is None:
            return [None, None]
        P = Phase.BACKWARD
        from .shape import Shape

        shp = b.op1(Shape(), node.inputs[0], phase=P)
        gg = b.op1(GatherGrad(axis=self.axis), shp, node.inputs[1], g, phase=P)
        return [gg, None]


@dataclass
class GatherGrad(MilliOp):
    """Scatter-add gradient of Gather: (data_shape, indices, grad) -> d(data).

    Reference: src/milli_graph/ops/mod.rs GatherGrad; a segment sum.
    """

    axis: int = 0
    KIND = "GatherGrad"

    def eval(self, inputs):
        shape, idx, g = inputs
        shape = tuple(int(x) for x in np.asarray(shape).reshape(-1))
        ax = self.axis % len(shape)
        from .common import downcast_result, upcast_for_compute

        gc, orig = upcast_for_compute(g)
        out = np.zeros(shape, dtype=gc.dtype)
        idxf = idx.astype(np.int64).reshape(-1)
        idxf = np.where(idxf < 0, idxf + shape[ax], idxf)
        # flatten index dims into the gather axis, move that axis to front
        g_flat = gc.reshape(shape[:ax] + (idxf.size,) + shape[ax + 1:])
        out_moved = np.moveaxis(out, ax, 0)
        np.add.at(out_moved, idxf, np.moveaxis(g_flat, ax, 0))
        return [downcast_result(out, orig)]

    def infer(self, infos):
        shape = infos[0]
        dt = infos[2].dtype
        if shape.level is Level.NUMERIC:
            dims = [int(x) for x in shape.value.reshape(-1)]
            return [TensorInfo.shaped(dt, dims)]
        return [TensorInfo.minimal(dt)]


@dataclass
class GatherElements(MilliOp):
    """ONNX GatherElements: np.take_along_axis."""

    axis: int = 0
    KIND = "GatherElements"

    def eval(self, inputs):
        data, idx = inputs
        ax = self.axis % data.ndim
        idx = idx.astype(np.int64)
        idx = np.where(idx < 0, idx + data.shape[ax], idx)
        return [np.take_along_axis(data, idx, axis=ax)]


    def infer(self, infos):
        data, idx = infos
        if data.level is Level.NUMERIC and idx.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([data.value, idx.value])[0])]
        if idx.dims() is not None:
            return [TensorInfo.shaped(data.dtype, list(idx.dims()))]
        if idx.rank is not None:
            return [TensorInfo.ranked(data.dtype, idx.rank)]
        return [TensorInfo.minimal(data.dtype)]

    def backward(self, b, node, out_grads):
        """grad_data = sum_K onehot(idx) * g along the gathered axis.
        Non-last axes transpose the axis to the end, apply the last-axis
        rule, and transpose back (needs rank info)."""
        g = out_grads[0]
        if g is None:
            return [None, None]
        info = b.tensors[node.inputs[0]].info
        rank = info.rank if info is not None else None
        last = self.axis == -1 or (rank is not None
                                   and self.axis % rank == rank - 1)
        if not last and rank is None:
            raise NotImplementedError(
                "GatherElements backward: non-last axis without rank info")
        from .misc import OneHotMilli
        from .shape import GatherShape, Shape, Transpose, Unsqueeze

        P = Phase.BACKWARD
        data, idx = node.inputs
        from .basic import CastLike, Constant, SimpleBinary

        if last:
            depth_src, g_in, idx_in = data, g, idx
            shp = b.op1(Shape(start=-1), data, phase=P)               # [V]
            depth = b.op1(GatherShape(0), shp, phase=P)
        else:
            ax = self.axis % rank
            perm = [i for i in range(rank) if i != ax] + [ax]
            inv = [int(i) for i in np.argsort(perm)]
            g_in = b.op1(Transpose(perm=perm), g, phase=P)
            idx_in = b.op1(Transpose(perm=perm), idx, phase=P)
            shp = b.op1(Shape(), data, phase=P)
            depth = b.op1(GatherShape(ax), shp, phase=P)
        vals = b.op1(Constant(np.asarray([0.0, 1.0], dtype=np.float32)), phase=P)
        valsc = b.op1(CastLike(), vals, g, phase=P)
        hot = b.op1(OneHotMilli(axis=-1), idx_in, depth, valsc, phase=P)  # (...,K,V)
        gk = b.op1(Unsqueeze(axes=[-1]), g_in, phase=P)                   # (...,K,1)
        contrib = b.op1(SimpleBinary("mul"), hot, gk, phase=P)
        from .reduce import Reduce

        gd = b.op1(Reduce("sum", axes=[-2], keepdims=False), contrib, phase=P)
        if not last:
            gd = b.op1(Transpose(perm=inv), gd, phase=P)
        return [gd, None]


@dataclass
class GatherND(MilliOp):
    batch_dims: int = 0
    KIND = "GatherND"

    def eval(self, inputs):
        data, idx = inputs
        idx = idx.astype(np.int64)
        b = self.batch_dims
        if b == 0:
            k = idx.shape[-1]
            flat_idx = idx.reshape(-1, k)
            out = data[tuple(flat_idx.T)]
            return [out.reshape(idx.shape[:-1] + data.shape[k:])]
        # batched: iterate batch dims
        batch_shape = data.shape[:b]
        k = idx.shape[-1]
        out_shape = idx.shape[:-1] + data.shape[b + k:]
        out = np.empty(out_shape, dtype=data.dtype)
        for bi in np.ndindex(*batch_shape):
            sub_idx = idx[bi].reshape(-1, k)
            sub = data[bi][tuple(sub_idx.T)]
            out[bi] = sub.reshape(idx[bi].shape[:-1] + data.shape[b + k:])
        return [out]


    def infer(self, infos):
        data, idx = infos
        if data.level is Level.NUMERIC and idx.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([data.value, idx.value])[0])]
        dd, di = data.dims(), idx.dims()
        if dd is not None and di is not None and di[-1].is_known:
            k = int(di[-1].value())
            out = list(di[:-1]) + list(dd[self.batch_dims + k:])
            return [TensorInfo.shaped(data.dtype, out)]
        return [TensorInfo.minimal(data.dtype)]


@dataclass
class ScatterND(MilliOp):
    reduction: str = "none"  # none | add | mul | max | min
    KIND = "ScatterND"

    def eval(self, inputs):
        data, idx, updates = inputs
        out = data.copy()
        idx = idx.astype(np.int64)
        k = idx.shape[-1]
        flat_idx = tuple(idx.reshape(-1, k).T)
        upd = updates.reshape((-1,) + data.shape[k:])
        if self.reduction == "none":
            out[flat_idx] = upd
        elif self.reduction == "add":
            np.add.at(out, flat_idx, upd)
        elif self.reduction == "mul":
            np.multiply.at(out, flat_idx, upd)
        elif self.reduction == "max":
            np.maximum.at(out, flat_idx, upd)
        elif self.reduction == "min":
            np.minimum.at(out, flat_idx, upd)
        return [out]


    def infer(self, infos):
        data = infos[0]
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [data.forget_value()]


@dataclass
class Range(MilliOp):
    """start, limit, delta (scalars) -> 1-D tensor. Static under jit."""

    KIND = "Range"

    def eval(self, inputs):
        s, l, d = (np.asarray(x).reshape(()) for x in inputs)
        return [np.arange(s, l, d, dtype=inputs[0].dtype)]


    def infer(self, infos):
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [TensorInfo.ranked(infos[0].dtype, 1)]


@dataclass
class ScatterElementsMilli(MilliOp):
    """ONNX ScatterElements: the inverse of GatherElements — write
    `updates` into `data` at per-element positions `idx` along `axis`,
    with optional add/mul/max/min reduction."""

    axis: int = 0
    reduction: str = "none"  # none | add | mul | max | min
    KIND = "ScatterElements"

    def eval(self, inputs):
        data, idx, upd = inputs
        ax = self.axis % data.ndim
        idx = idx.astype(np.int64)
        idx = np.where(idx < 0, idx + data.shape[ax], idx)
        out = data.copy()
        if self.reduction == "none":
            np.put_along_axis(out, idx, upd, axis=ax)
            return [out]
        grids = list(np.indices(idx.shape))
        grids[ax] = idx
        fi = tuple(g.reshape(-1) for g in grids)
        uf = upd.reshape(-1)
        if self.reduction == "add":
            np.add.at(out, fi, uf)
        elif self.reduction == "mul":
            np.multiply.at(out, fi, uf)
        elif self.reduction == "max":
            np.maximum.at(out, fi, uf)
        elif self.reduction == "min":
            np.minimum.at(out, fi, uf)
        else:
            raise NotImplementedError(self.reduction)
        return [out]


    def infer(self, infos):
        data = infos[0]
        if all(i.level is Level.NUMERIC for i in infos):
            return [TensorInfo.numeric(self.eval([i.value for i in infos])[0])]
        return [data.forget_value()]


# -- lowerings ----------------------------------------------------------


@lowering("Gather")
def gather(op, inputs, static, device):
    data, idx = inputs
    ax = op.axis % data.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + data.shape[ax], idx)
    out = torch.index_select(data, ax, idx.reshape(-1))
    return [out.reshape(data.shape[:ax] + idx.shape + data.shape[ax + 1:])]


@lowering("GatherGrad")
def gather_grad(op, inputs, static, device):
    shape = tuple(int(x) for x in need_static(static, 0, "GatherGrad")
                  .reshape(-1))
    idx, g = inputs[1], inputs[2]
    ax = op.axis % len(shape)
    flat = _norm_idx(idx.reshape(-1), shape[ax])
    # 16-bit floats sum in f32 and round once, as the oracle
    acc = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) \
        else g.dtype
    g2 = g.reshape(shape[:ax] + (flat.numel(),) + shape[ax + 1:]).to(acc)
    out = torch.zeros(shape, dtype=acc, device=g.device)
    return [out.index_add_(ax, flat, g2).to(g.dtype)]


@lowering("Range")
def range_(op, inputs, static, device):
    s, l, d = (need_static(static, i, "Range").reshape(()).item()
               for i in range(3))
    return [torch.arange(s, l, d, dtype=inputs[0].dtype, device=device)]


def _norm_idx(idx: torch.Tensor, dim: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + dim, idx)


@lowering("GatherElements")
def gather_elements(op, inputs, static, device):
    data, idx = inputs
    ax = op.axis % data.ndim
    return [torch.gather(data, ax, _norm_idx(idx, data.shape[ax]))]


def _linear(idx: torch.Tensor, dims) -> torch.Tensor:
    """(..., k) coordinates over `dims` -> (...) row-major linear index."""
    lin = torch.zeros(idx.shape[:-1], dtype=torch.long, device=idx.device)
    for j, d in enumerate(dims):
        lin = lin * d + _norm_idx(idx[..., j], d)
    return lin


@lowering("GatherND")
def gather_nd(op, inputs, static, device):
    data, idx = inputs
    bd, k = op.batch_dims, idx.shape[-1]
    idx = idx.long()
    if bd:
        # prepend each row's batch coordinates (reference :223-256)
        coords = [torch.arange(idx.shape[i], device=idx.device).reshape(
            [-1 if j == i else 1 for j in range(idx.ndim - 1)] + [1])
            .expand(*idx.shape[:-1], 1) for i in range(bd)]
        idx = torch.cat(coords + [idx], dim=-1)
    lead = data.shape[:bd + k]
    flat = data.reshape((-1,) + tuple(data.shape[bd + k:]))
    out = flat[_linear(idx, lead).reshape(-1)]
    return [out.reshape(tuple(idx.shape[:-1]) + tuple(data.shape[bd + k:]))]


_REDUCE = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}


def _last_writes(lin: torch.Tensor, n: int) -> torch.Tensor:
    """Which of the writes to positions `lin` (of n) land, as the oracle's
    numpy assignment does: the last write to each position. (A CUDA
    scatter with repeated positions keeps an arbitrary one.)"""
    order = torch.arange(lin.numel(), device=lin.device)
    last = torch.full((n,), -1, dtype=torch.long, device=lin.device)
    last.scatter_reduce_(0, lin, order, "amax")
    return last[lin] == order


@lowering("ScatterND")
def scatter_nd(op, inputs, static, device):
    data, idx, updates = inputs
    k = idx.shape[-1]
    rest = tuple(data.shape[k:])
    out = widen(data).clone()
    flat = out.reshape((-1,) + rest)
    lin = _linear(idx.long(), data.shape[:k]).reshape(-1)
    upd = widen(updates).reshape((-1,) + rest).to(out.dtype)
    if op.reduction == "none":
        keep = _last_writes(lin, flat.shape[0])
        flat.index_copy_(0, lin[keep], upd[keep])
    else:
        lin = lin.reshape((-1,) + (1,) * len(rest)).expand_as(upd)
        flat.scatter_reduce_(0, lin, upd, _REDUCE[op.reduction])
    return [narrow(out, data.dtype)]


@lowering("ScatterElements")
def scatter_elements(op, inputs, static, device):
    data, idx, upd = inputs
    ax = op.axis % data.ndim
    idx = _norm_idx(idx, data.shape[ax])
    out = widen(data)
    upd = widen(upd).to(out.dtype)
    if op.reduction == "none":
        # each update's flat position in data; the last write wins
        out = out.contiguous().clone()
        pos = list(torch.meshgrid(*[torch.arange(d, device=idx.device)
                                    for d in idx.shape], indexing="ij"))
        pos[ax] = idx
        lin = sum(p.reshape(-1) * st for p, st in zip(pos, out.stride()))
        keep = _last_writes(lin, out.numel())
        out.view(-1)[lin[keep]] = upd.reshape(-1)[keep]
    else:
        out = out.scatter_reduce(ax, idx, upd, _REDUCE[op.reduction])
    return [narrow(out, data.dtype)]
