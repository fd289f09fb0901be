"""Misc milli ops: Trilu, EyeLike, OneHot, Tile, DepthToSpace,
SpaceToDepth and DynUpdateSlice, the recipes' KV-cache write
(CacheWrite); KVWrite, the port's merge of a layer's two cache writes;
and their PyTorch lowerings.

The classes but KVWrite are the port's copy of whisper_tensor_tpu/milli/
ops/misc.py (numpy `eval` and shape inference; no `to_jax`).

Counterpart of whisper_tensor_tpu/milli/ops/misc.py:258. The reference
is functional and relies on buffer donation (interfaces/text.py:806-807)
for XLA to write in place. Eager PyTorch has no donation, so these
lowerings write INTO the cache and return that same tensor: the cache a
caller passes in is updated. A negative start counts from the end and
every start is then clamped so the update fits, as the reference's
jax.lax.dynamic_update_slice does; starts stay on the device.

The recipes write a layer's K and V caches with the same start. The
text interface's graph pass pair_cache_writes (milli/transforms.py)
merges the two writes into one KVWrite node, whose lowering is one
call of kv_write_pair (backends/cuda/kv_write.py): on a CUDA device one
launch of the ragged_kv_write kernel writes both caches, for a per-row
start (B,), the batcher's, and for a scalar start, the direct path's
(read with stride 0), or raises. The reference dispatches a per-row
write to its Pallas kernel (misc.py:263-273) and leaves a scalar start
to XLA's own dynamic_update_slice.

A write that does not pair keeps its DynUpdateSlice lowering: a per-row
start on axis 2 of a 4-D cache goes to the kernel's single-cache
wrapper ragged_kv_write; any other per-row write is an indexed store and
a scalar start an index_copy_.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...backends.cuda.kv_write import (clamped_start, kv_write_pair,
                                       ragged_kv_write)
from ...dtype import DType, to_device
from ...scalar_info import ScalarInfo
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering, need_static
from .lowering_common import np_dtype


@dataclass
class TriluMilli(MilliOp):
    upper: bool = True
    KIND = "Trilu"

    def eval(self, inputs):
        x = inputs[0]
        k = int(np.asarray(inputs[1]).reshape(())) if len(inputs) > 1 and inputs[1] is not None else 0
        return [np.triu(x, k) if self.upper else np.tril(x, k)]


    def infer(self, infos):
        i = infos[0]
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [i.forget_value()]


@dataclass
class EyeLikeMilli(MilliOp):
    dtype: Optional[DType] = None
    k: int = 0
    KIND = "EyeLike"

    def _dt(self, x):
        return (self.dtype or DType.from_numpy(x.dtype)).to_numpy()

    def eval(self, inputs):
        x = inputs[0]
        return [np.eye(x.shape[0], x.shape[1], k=self.k, dtype=self._dt(x))]


    def infer(self, infos):
        i = infos[0]
        dt = self.dtype or i.dtype
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        return [TensorInfo(dt, min(i.level, Level.SHAPED), shape=i.shape, rank_=i.rank_)]


@dataclass
class OneHotMilli(MilliOp):
    """indices, depth, values([off,on]) -> one-hot."""

    axis: int = -1
    KIND = "OneHot"

    def eval(self, inputs):
        idx, depth, values = inputs
        d = int(np.asarray(depth).reshape(-1)[0])
        off, on = np.asarray(values).reshape(-1)[:2]
        ax = self.axis % (idx.ndim + 1)
        ii = idx.astype(np.int64)
        ii = np.where(ii < 0, ii + d, ii)
        eye = np.arange(d).reshape((1,) * idx.ndim + (d,))
        hot = (np.expand_dims(ii, -1) == eye)
        out = np.where(hot, on, off).astype(np.asarray(values).dtype)
        return [np.moveaxis(out, -1, ax)]


    def infer(self, infos):
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        idx, depth, values = infos
        dt = values.dtype
        dims = idx.dims()
        if dims is not None and depth.level is Level.NUMERIC:
            d = int(np.asarray(depth.value).reshape(-1)[0])
            ax = self.axis % (len(dims) + 1)
            out = list(dims)
            out.insert(ax, ScalarInfo.of(d))
            return [TensorInfo.shaped(dt, out)]
        if idx.rank is not None:
            return [TensorInfo.ranked(dt, idx.rank + 1)]
        return [TensorInfo.minimal(dt)]


@dataclass
class TileMilli(MilliOp):
    """data, repeats(i64) -> np.tile."""

    KIND = "Tile"

    def eval(self, inputs):
        x, reps = inputs
        return [np.tile(x, tuple(int(r) for r in np.asarray(reps).reshape(-1)))]


    def infer(self, infos):
        x, reps = infos
        if x.level is Level.NUMERIC and reps.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([x.value, reps.value])[0])]
        dims = x.dims()
        if dims is not None and reps.level is Level.NUMERIC:
            rv = [int(r) for r in reps.value.reshape(-1)]
            out = [d * ScalarInfo.of(r) for d, r in zip(dims, rv)]
            return [TensorInfo.shaped(x.dtype, out)]
        if x.rank is not None:
            return [TensorInfo.ranked(x.dtype, x.rank)]
        return [TensorInfo.minimal(x.dtype)]


@dataclass
class DepthToSpaceMilli(MilliOp):
    blocksize: int = 1
    mode: str = "DCR"
    KIND = "DepthToSpace"

    def _apply(self, x, xp):
        b = self.blocksize
        N, C, H, W = x.shape
        if self.mode == "DCR":
            t = x.reshape(N, b, b, C // (b * b), H, W)
            t = xp.transpose(t, (0, 3, 4, 1, 5, 2))
        else:  # CRD
            t = x.reshape(N, C // (b * b), b, b, H, W)
            t = xp.transpose(t, (0, 1, 4, 2, 5, 3))
        return t.reshape(N, C // (b * b), H * b, W * b)

    def eval(self, inputs):
        return [self._apply(inputs[0], np)]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        cs = i.concrete_shape()
        if cs is not None:
            b = self.blocksize
            N, C, H, W = cs
            return [TensorInfo.shaped(i.dtype, [N, C // (b * b), H * b, W * b])]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank)]
        return [TensorInfo.minimal(i.dtype)]


@dataclass
class SpaceToDepthMilli(MilliOp):
    blocksize: int = 1
    KIND = "SpaceToDepth"

    def _apply(self, x, xp):
        b = self.blocksize
        N, C, H, W = x.shape
        t = x.reshape(N, C, H // b, b, W // b, b)
        t = xp.transpose(t, (0, 3, 5, 1, 2, 4))
        return t.reshape(N, C * b * b, H // b, W // b)

    def eval(self, inputs):
        return [self._apply(inputs[0], np)]


    def infer(self, infos):
        i = infos[0]
        if i.level is Level.NUMERIC:
            return [TensorInfo.numeric(self.eval([i.value])[0])]
        cs = i.concrete_shape()
        if cs is not None:
            b = self.blocksize
            N, C, H, W = cs
            return [TensorInfo.shaped(i.dtype, [N, C * b * b, H // b, W // b])]
        if i.rank is not None:
            return [TensorInfo.ranked(i.dtype, i.rank)]
        return [TensorInfo.minimal(i.dtype)]


@dataclass
class DynUpdateSliceMilli(MilliOp):
    """data, update, start(scalar i64 | (B,) i64) -> data with update
    written at offset `start` along `axis`. The static-shape KV-cache
    write: maps to jax.lax.dynamic_update_slice_in_dim (XLA
    DynamicUpdateSlice), which donated-buffer jit turns into an in-place
    write on TPU. A (B,) start writes PER BATCH ROW (dim 0) — the
    ragged-decode KV write for continuous batching (lowered via vmap)."""

    axis: int = 0
    KIND = "DynUpdateSlice"

    def eval(self, inputs):
        data, update, start = inputs
        ax = self.axis % data.ndim
        s_arr = np.asarray(start)
        out = data.copy()
        if s_arr.ndim == 1:
            for bi in range(data.shape[0]):
                s = int(s_arr[bi])
                idx = [slice(None)] * (data.ndim - 1)
                idx[ax - 1] = slice(s, s + update.shape[ax])
                out[bi][tuple(idx)] = update[bi].astype(data.dtype)
            return [out]
        s = int(s_arr.reshape(()))
        idx = [slice(None)] * data.ndim
        idx[ax] = slice(s, s + update.shape[ax])
        out[tuple(idx)] = update.astype(data.dtype)
        return [out]


    def infer(self, infos):
        if all(f.level is Level.NUMERIC for f in infos):
            return [TensorInfo.numeric(self.eval([f.value for f in infos])[0])]
        return [infos[0].forget_value()]


@dataclass
class KVWriteMilli(MilliOp):
    """cache_k, update_k, cache_v, update_v, start -> (cache_k, cache_v)
    with each update written at `start` along `axis`: two
    DynUpdateSliceMilli writes that share their start, which
    pair_cache_writes (milli/transforms.py) merges into one node. A
    port-side op; the JAX package has no counterpart."""

    axis: int = 2
    KIND = "KVWrite"

    def eval(self, inputs):
        cache_k, update_k, cache_v, update_v, start = inputs
        write = DynUpdateSliceMilli(axis=self.axis)
        return (write.eval([cache_k, update_k, start])
                + write.eval([cache_v, update_v, start]))


# -- lowerings ----------------------------------------------------------


@lowering("DynUpdateSlice")
def dyn_update_slice(op, inputs, static, device):
    data, update, start = inputs
    ax = op.axis % data.ndim
    n = update.shape[ax]
    if start.ndim == 1:
        if ax == 2 and data.ndim == 4:
            return [ragged_kv_write(data, update, start)]
        # per-row start (B,): write row b at [b, ..., start[b] + i, ...]
        s = clamped_start(start, data.shape[ax], n)
        rows = torch.arange(data.shape[0], device=data.device)[:, None]
        cols = s[:, None] + torch.arange(n, device=data.device)[None, :]
        view = data.movedim(ax, 1)                      # (B, L, ...)
        view[rows, cols] = update.movedim(ax, 1).to(data.dtype)
        return [data]
    s = clamped_start(start.reshape(()), data.shape[ax], n)
    data.index_copy_(ax, s + torch.arange(n, device=data.device),
                     update.to(data.dtype))
    return [data]


@lowering("KVWrite")
def kv_write(op, inputs, static, device):
    cache_k, update_k, cache_v, update_v, start = inputs
    return list(kv_write_pair(cache_k, update_k, cache_v, update_v, start))


@lowering("Trilu")
def trilu(op, inputs, static, device):
    k = 0
    if len(inputs) > 1 and inputs[1] is not None:
        k = int(need_static(static, 1, "Trilu").reshape(()))
    x = inputs[0]
    rows, cols = x.shape[-2], x.shape[-1]
    i = torch.arange(rows, device=x.device).unsqueeze(1)
    j = torch.arange(cols, device=x.device).unsqueeze(0)
    keep = (j - i >= k) if op.upper else (j - i <= k)
    return [torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))]


@lowering("EyeLike")
def eye_like(op, inputs, static, device):
    x = inputs[0]
    eye = op.eval([np.zeros(tuple(x.shape), np_dtype(x.dtype))])[0]
    return [to_device(eye, device)]


@lowering("OneHot")
def one_hot(op, inputs, static, device):
    idx, _, values = inputs
    d = int(need_static(static, 1, "OneHot").reshape(-1)[0])
    vals = values.reshape(-1)
    ax = op.axis % (idx.ndim + 1)
    ii = idx.long()
    ii = torch.where(ii < 0, ii + d, ii)
    hot = ii.unsqueeze(-1) == torch.arange(d, device=idx.device)
    out = torch.where(hot, vals[1], vals[0])
    return [out.movedim(-1, ax)]


@lowering("Tile")
def tile(op, inputs, static, device):
    reps = need_static(static, 1, "Tile")
    return [inputs[0].repeat(tuple(int(r) for r in reps.reshape(-1)))]


class _TorchXp:
    """The one numpy function DepthToSpace/SpaceToDepth `_apply` calls."""

    @staticmethod
    def transpose(t, perm):
        return t.permute(perm)


@lowering("DepthToSpace")
def depth_to_space(op, inputs, static, device):
    return [op._apply(inputs[0], _TorchXp)]


@lowering("SpaceToDepth")
def space_to_depth(op, inputs, static, device):
    return [op._apply(inputs[0], _TorchXp)]
