"""Gather and Range lowerings (whisper_tensor_tpu/milli/ops/index.py)."""

from __future__ import annotations

import torch

from ..registry import lowering
from .shape import _need_static


@lowering("Gather")
def gather(op, inputs, static, device):
    data, idx = inputs
    ax = op.axis % data.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + data.shape[ax], idx)
    out = torch.index_select(data, ax, idx.reshape(-1))
    return [out.reshape(data.shape[:ax] + idx.shape + data.shape[ax + 1:])]


@lowering("Range")
def range_(op, inputs, static, device):
    s, l, d = (_need_static(static, i, "Range").reshape(()).item()
               for i in range(3))
    return [torch.arange(s, l, d, dtype=inputs[0].dtype, device=device)]
