"""DynUpdateSlice lowering: the recipes' KV-cache write (CacheWrite).

Counterpart of whisper_tensor_tpu/milli/ops/misc.py:258. The reference
is functional and relies on buffer donation (interfaces/text.py:806-807)
for XLA to write in place. Eager PyTorch has no donation, so this
lowering writes INTO `data` and returns that same tensor: the cache a
caller passes in is updated. A negative start counts from the end and
every start is then clamped so the update fits, as the reference's
jax.lax.dynamic_update_slice does; starts stay on the device.

A per-row start (B,) on axis 2 of a 4-D cache, the batcher's ragged
write, goes to the ragged_kv_write kernel's wrapper
(backends/cuda/kv_write.py), which on a CUDA device launches the kernel
or raises, as the reference dispatches it to its Pallas kernel
(misc.py:263-273). A scalar start is XLA's own dynamic_update_slice in
the reference, not a kernel, and stays an index_copy_ here.
"""

from __future__ import annotations

import torch

from ...backends.cuda.kv_write import clamped_start, ragged_kv_write
from ..registry import lowering


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
