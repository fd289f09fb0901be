"""Gather and Range: the milli op classes and their PyTorch lowerings.

The classes are the port's copy of the two of whisper_tensor_tpu/milli/
ops/index.py that the text recipes emit (numpy `eval` and shape
inference; no `to_jax`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...tensor_info import Level, TensorInfo
from ..ir import MilliOp
from ..registry import lowering
from .shape import _need_static


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


# -- lowerings ----------------------------------------------------------


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
