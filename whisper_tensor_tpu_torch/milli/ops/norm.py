"""RMSNorm lowering (whisper_tensor_tpu/milli/ops/norm.py:176).

Statistics in f32 (the ONNX stash_type=1 default), output rounded back
to the input type once.
"""

from __future__ import annotations

import torch

from ..registry import lowering


@lowering("RMSNorm")
def rms_norm(op, inputs, static, device):
    x, scale = inputs[0], inputs[1]
    dims = tuple(range(op.axis % x.ndim, x.ndim))
    xp = x.float() if op.stash_f32 else x
    ms = (xp * xp).mean(dim=dims, keepdim=True)
    y = xp * torch.rsqrt(ms + op.epsilon)
    return [(y * scale.to(xp.dtype)).to(x.dtype)]
