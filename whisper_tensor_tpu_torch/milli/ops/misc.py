"""DynUpdateSlice: the recipes' KV-cache write (CacheWrite), its milli
op class and its PyTorch lowering; KVWrite, the port's merge of a
layer's two cache writes, and its lowering.

DynUpdateSliceMilli is the port's copy of the class in
whisper_tensor_tpu/milli/ops/misc.py (numpy `eval` and shape inference;
no `to_jax`).

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

import numpy as np
import torch

from ...backends.cuda.kv_write import (clamped_start, kv_write_pair,
                                       ragged_kv_write)
from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering


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
