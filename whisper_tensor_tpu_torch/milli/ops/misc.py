"""DynUpdateSlice lowering: the recipes' KV-cache write (CacheWrite).

Counterpart of whisper_tensor_tpu/milli/ops/misc.py:258. The reference
is functional and relies on buffer donation (interfaces/text.py:806-807)
for XLA to write in place. Eager PyTorch has no donation, so this
lowering writes INTO `data` and returns that same tensor: the cache a
caller passes in is updated. Start offsets are clamped so the update
fits, as XLA's DynamicUpdateSlice does, and stay on the device.
"""

from __future__ import annotations

import torch

from ..registry import lowering


@lowering("DynUpdateSlice")
def dyn_update_slice(op, inputs, static, device):
    data, update, start = inputs
    ax = op.axis % data.ndim
    n = update.shape[ax]
    span = torch.arange(n, device=data.device)
    if start.ndim == 1:
        # per-row start (B,): write row b at [b, ..., start[b] + i, ...]
        s = start.long().clamp(0, data.shape[ax] - n)
        rows = torch.arange(data.shape[0], device=data.device)[:, None]
        cols = s[:, None] + span[None, :]
        view = data.movedim(ax, 1)                      # (B, L, ...)
        view[rows, cols] = update.movedim(ax, 1).to(data.dtype)
        return [data]
    s = start.reshape(()).long().clamp(0, data.shape[ax] - n)
    data.index_copy_(ax, s + span, update.to(data.dtype))
    return [data]
