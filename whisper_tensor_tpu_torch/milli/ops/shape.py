"""Shape, Reshape, Transpose, Squeeze, Unsqueeze and Split lowerings.

Counterparts of whisper_tensor_tpu/milli/ops/shape.py. Shape arguments
(Reshape's target, Squeeze/Unsqueeze axes, Split sizes) must be static:
the executor folds them on the host, as the XLA tracer does. The shape
arithmetic itself is the reference op's own (its `_target`, `_perm`,
`_axes`, `_expand`, `_sizes` helpers are plain Python).
"""

from __future__ import annotations

import numpy as np
import torch

from ..registry import lowering


def _need_static(static, idx: int, what: str) -> np.ndarray:
    if static is None or static[idx] is None:
        raise NotImplementedError(
            f"{what}: input {idx} must be static (host-folded)")
    return np.asarray(static[idx])


@lowering("Shape")
def shape(op, inputs, static, device):
    sh = tuple(inputs[0].shape)
    s, e = op._slice(len(sh))
    return [torch.tensor(sh[s:e], dtype=torch.int64, device=device)]


@lowering("Reshape")
def reshape(op, inputs, static, device):
    spec = _need_static(static, 1, "Reshape").reshape(-1)
    x = inputs[0]
    return [x.reshape(op._target(tuple(x.shape), spec))]


@lowering("Transpose")
def transpose(op, inputs, static, device):
    x = inputs[0]
    return [x.permute(op._perm(x.ndim))]


@lowering("Squeeze")
def squeeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = _need_static(static, 1, "Squeeze") if len(inputs) > 1 else None
    axes = set(op._axes(tuple(x.shape), axes_arr))
    return [x.reshape([d for i, d in enumerate(x.shape) if i not in axes])]


@lowering("Unsqueeze")
def unsqueeze(op, inputs, static, device):
    x = inputs[0]
    axes_arr = (_need_static(static, 1, "Unsqueeze") if len(inputs) > 1
                else None)
    return [x.reshape(op._expand(tuple(x.shape), axes_arr))]


@lowering("Split")
def split(op, inputs, static, device):
    x = inputs[0]
    sizes_arr = _need_static(static, 1, "Split") if len(inputs) > 1 else None
    sizes = op._sizes(tuple(x.shape), sizes_arr)
    return list(torch.split(x, sizes, dim=op.axis))
